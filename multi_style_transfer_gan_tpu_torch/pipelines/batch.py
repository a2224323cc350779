"""Batch folder processing — the throughput path (port of
``pipelines/batch.py``).

- Decode + canvas paste on the host: the native libjpeg-turbo loader
  (``native/``, bound by the port's ``native`` module) where it is built,
  PIL LANCZOS (the reference recipe) otherwise.
- One uint8 -> uint8 program per configuration runs normalize ->
  generator -> ``from_model_range`` -> round and clip on the device, with
  one of two engines of the same math: the NHWC ``EnhancedGenerator`` or
  the packed (space-to-depth) ``PackedEnhancedGenerator``; ``auto`` picks
  one by ``select_engine``, as the JAX package does. ``int8`` is the
  EXPERIMENTAL post-training-quantized engine
  (``QuantizedEnhancedGenerator``), an approximation of the same network
  calibrated on the folder's first images. A plain generator checkpoint
  runs its own forward (``PlainGenerator``) under any of them.
- A bounded prefetch thread decodes and copies the next batches to the
  device while the current one runs; a one-worker fetch pool copies
  results back in order and a save pool encodes them.
- Data parallel (``devices=[...]``, the batch CLI's ``--data_parallel``;
  the JAX package's ``mesh``): one process, a replica of the program on
  each device, the batch rounded up to a multiple of the device count and
  split into one block a replica; the blocks are queued on their devices
  one after another (CUDA runs them concurrently) and gathered back to the
  host for the save.

Every mode of the JAX pipeline is ported: ``cyclegan``, and
``local_style`` with the ``simple`` blend or the ``enhanced`` and
``advanced`` post chains (sky and detail masks, per-pixel weight blend,
colour boost and transition smoothing, or YUV equalize and guided filter),
which run in fp32 on the device inside the same program, whatever the
generator's dtype. As in the JAX package, 'advanced' omits the reference's
unused mean-shift segmentation and its "sharpening", which blends the
image with itself (addWeighted(x, 1.5, x, -0.5) == x).
A kernel that fails to build or launch raises: there is no degraded path.
"""

from __future__ import annotations

import copy
import ctypes
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from PIL import Image

from .. import native as _native
from ..data import list_images
from ..ops import from_model_range, restore_aspect, to_model_range
from ..ops.color import rgb_to_gray, rgb_to_hsv, rgb_to_yuv, yuv_to_rgb
from ..ops.filters import (
    canny, convert_scale_abs, dilate, equalize_hist, erode, gaussian_blur,
    gaussian_filter, guided_filter,
)
from ..models import PackedEnhancedGenerator, prepare_int8_model
from ..models.quantized_generator import EXPERIMENTAL_WARNING
from .model_loader import LoadedModel

CANVAS = 256
PREFETCH_DEPTH = 2   # decoded batches queued ahead of the device
MODES = ("cyclegan", "local_style")
LOCAL_STYLE_MODES = ("simple", "enhanced", "advanced")


# ---------------------------------------------------------------------------
# host side: decode + canvas paste, restore + save
# ---------------------------------------------------------------------------

def _decode_canvas(path, canvas=CANVAS, fill=255):
    """PIL decode, aspect-preserving LANCZOS resize, centred paste on a
    ``fill`` canvas (the reference's batch_process_images.py:186-200)."""
    img = Image.open(path).convert("RGB")
    w, h = img.size
    if w > h:
        nw, nh = canvas, int(h * (canvas / w))
    else:
        nh, nw = canvas, int(w * (canvas / h))
    resized = img.resize((nw, nh), Image.LANCZOS)
    cv = Image.new("RGB", (canvas, canvas), (fill,) * 3)
    cv.paste(resized, ((canvas - nw) // 2, (canvas - nh) // 2))
    return np.asarray(cv, np.uint8), (w, h)


def _restore_and_save(out_u8, orig_wh, out_path, canvas=CANVAS):
    """Aspect crop + resize back when <= 1 MP + save."""
    img = restore_aspect(out_u8, orig_wh, canvas)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    img.save(out_path)


def _decode_batch(paths, canvas, num_threads):
    """Decode ``paths`` into one (N, canvas, canvas, 3) uint8 array.

    Calls the native library's batch decode directly.

    Returns (batch, sizes, ok). The native decoder takes what it can; the
    rest go through PIL, and files neither can read stay ok=False (skipped,
    like the reference's per-image try/except)."""
    n = len(paths)
    out = np.empty((n, canvas, canvas, 3), np.uint8)
    whs = np.zeros((n, 2), np.int32)
    ok = np.zeros((n,), np.uint8)
    lib = _native.load_library()
    if lib is not None and n:
        names = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        lib.mstgan_decode_canvas_batch(
            names, n, canvas, 255,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            whs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), num_threads)
    for i in np.flatnonzero(ok == 0):
        try:
            out[i], whs[i] = _decode_canvas(paths[i], canvas)
            ok[i] = 1
        except (OSError, ValueError) as e:
            print(f"error processing image {paths[i]}: {e}")
    return out, [(int(w), int(h)) for w, h in whs], ok.astype(bool)


# ---------------------------------------------------------------------------
# device side: the local-style post chains (fp32, uint8 scale)
# ---------------------------------------------------------------------------

def _sky_mask(canvas_f):
    """detect_sky (reference :126-150): V > 150 and S < 100; an image 'has
    sky' when that holds on more than 0.7 of its pixels."""
    hsv = rgb_to_hsv(canvas_f)
    mask = (hsv[..., 2] > 150) & (hsv[..., 1] < 100)
    frac = mask.float().mean(dim=(1, 2))
    return mask, frac > 0.7


def _detail_mask(canvas_f):
    """Canny(50, 150), blurred at sigma 2, thresholded at 0.1 (:321-327)."""
    edges = canny(rgb_to_gray(canvas_f), 50.0, 150.0) > 0
    return gaussian_filter(edges.float(), 2.0) > 0.1


def _smooth_transitions(img_f, mask, radius=3, iterations=2):
    """smooth_transitions (:152-174): a Gaussian half-blend on the band
    between the mask's dilation and its erosion."""
    m = mask.float()
    boundary = (dilate(m, 5, iterations) - erode(m, 5, iterations)) > 0
    blurred = gaussian_blur(img_f, radius * 2 + 1)
    return torch.where(boundary[..., None], img_f * 0.5 + blurred * 0.5,
                       img_f)


def _postprocess(canvas_u8f, styled_u8f, mode, strength, detail,
                 enhance_colors, smooth):
    """The mode branch of the reference's process_local_style (:304-406) on
    (B, H, W, 3) fp32 batches in uint8 scale."""
    if mode == "simple":
        out = canvas_u8f * (1 - strength) + styled_u8f * strength
        return torch.clamp(out, 0, 255)

    sky, has_sky = _sky_mask(canvas_u8f)
    detail_mask = _detail_mask(canvas_u8f)
    weight = torch.full(canvas_u8f.shape[:-1], strength, dtype=torch.float32,
                        device=canvas_u8f.device)
    sky_w = min(strength + 0.2, 1.0)
    weight = torch.where(has_sky[:, None, None] & sky, sky_w, weight)
    detail_factor = 0.3 if mode == "enhanced" else 0.4
    detail_w = max(strength - detail_factor * detail, 0.0)
    weight = torch.where(detail_mask, detail_w, weight)
    out = (canvas_u8f * (1 - weight[..., None])
           + styled_u8f * weight[..., None])

    if mode == "enhanced":
        if enhance_colors:
            out = convert_scale_abs(out, alpha=1.1, beta=5)
        if smooth:
            out = _smooth_transitions(out, detail_mask, radius=3)
    else:  # advanced (:355-406)
        yuv = rgb_to_yuv(torch.clamp(out, 0, 255))
        yeq = equalize_hist(yuv[..., 0])
        out = yuv_to_rgb(torch.stack([yeq, yuv[..., 1], yuv[..., 2]], -1))
        out = guided_filter(out, out, radius=4, eps=1e-4)
    return torch.clamp(out, 0, 255)


# ---------------------------------------------------------------------------
# device side: the uint8 -> uint8 program
# ---------------------------------------------------------------------------

ENGINES = ("nhwc", "packed", "int8")
CALIBRATION_IMAGES = 8   # the int8 engine's calibration: the folder's first


def make_batch_fn(model: LoadedModel, mode: str = "cyclegan",
                  local_style_mode: str = "enhanced", strength: float = 0.8,
                  detail: float = 0.7, enhance_colors: bool = True,
                  smooth: bool = True, *, compute_dtype=None,
                  engine: str = "nhwc", calib_batches=None, device):
    """The uint8 (B, H, W, 3) -> uint8 (B, H, W, 3) program on ``device``.

    The returned function takes a numpy array or a tensor and returns a
    uint8 tensor on ``device``; on a CUDA device the work is queued and the
    caller's copy back to the host waits for it.

    compute_dtype: generator dtype (``torch.bfloat16`` is the fast path;
    None = fp32). The program runs its own copy of the module in that
    dtype. engine: 'nhwc' runs the ``EnhancedGenerator`` as it is; 'packed'
    the space-to-depth engine (``PackedEnhancedGenerator``, the same math,
    H and W multiples of 16), repacked from the model's weights here;
    'int8' the post-training-quantized engine
    (``QuantizedEnhancedGenerator``, bf16 compute whatever
    ``compute_dtype`` says), calibrated here on ``calib_batches``
    ((B, H, W, 3) arrays in [-1, 1]; None: ``prepare_int8_model``'s seeded
    synthetic batch). A plain model has one engine, its own forward,
    whichever is asked for.
    local_style_mode: 'simple', 'enhanced' or 'advanced' (mode
    'local_style' only); ``strength``, ``detail``, ``enhance_colors`` and
    ``smooth`` as in the JAX package. The post chain runs in fp32 on
    ``device`` in the same call as the generator.
    """
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r} "
                         f"(batch_process resolves 'auto' with select_engine)")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "local_style" and local_style_mode not in LOCAL_STYLE_MODES:
        raise ValueError(f"local_style_mode must be one of "
                         f"{LOCAL_STYLE_MODES}, got {local_style_mode!r}")
    device = torch.device(device)
    dtype = compute_dtype or torch.float32
    if model.kind == "plain":
        # one engine whatever ``engine`` says, as the JAX package's
        # pipelines/batch.py:173-174; its BatchNorms stay fp32 in bf16
        module = copy.deepcopy(model.module).to(device).cast_convs_(dtype)
    elif engine == "packed":
        module = PackedEnhancedGenerator(model.module).to(device=device,
                                                          dtype=dtype)
    elif engine == "int8":
        module = prepare_int8_model(copy.deepcopy(model.module).to(device),
                                    calib_batches)
    else:
        module = copy.deepcopy(model.module).to(device=device, dtype=dtype)

    @torch.inference_mode()
    def run(batch_u8):
        x = torch.as_tensor(batch_u8).to(device)
        y = module(to_model_range(x).to(dtype).permute(0, 3, 1, 2))
        out = from_model_range(y.float().permute(0, 2, 3, 1)) * 255.0
        if mode == "local_style":
            out = _postprocess(x.float(), out, local_style_mode, strength,
                               detail, enhance_colors, smooth)
        return torch.clamp(torch.round(out), 0, 255).to(torch.uint8).contiguous()

    run.module = module   # the program's own copy, in compute_dtype
    return run


# ---------------------------------------------------------------------------
# engine dispatch
# ---------------------------------------------------------------------------

def select_engine(batch_size: int, canvas: int,
                  kind: str = "enhanced") -> str:
    """(batch, canvas, model kind) -> engine, the JAX package's rule as it
    stands (``pipelines/batch.py::select_engine``): the enhanced generator
    at a batch of 32 or less takes the packed engine, every other case
    NHWC; the plain generator has one engine. ``canvas`` does not enter
    the rule yet: the rule was measured on another device, and ROADMAP.md
    queues its refit from H100 measurements. Dispatch only: both engines
    compute the same math."""
    if kind != "enhanced":
        return "nhwc"
    if batch_size <= 32:
        return "packed"
    return "nhwc"


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def batch_process(model: LoadedModel, input_dir, output_dir, *,
                  mode: str = "cyclegan", local_style_mode: str = "enhanced",
                  direction: str = "photo2monet", strength: float = 0.8,
                  detail: float = 0.7, enhance_colors: bool = True,
                  smooth: bool = True, batch_size: int = 64,
                  decode_workers: int = 8, compute_dtype=None,
                  engine: str = "auto", canvas: int = CANVAS,
                  device=None, devices=None) -> dict:
    """Process every image in ``input_dir`` on ``device``, or data parallel
    over the list ``devices``; returns a stats dict.

    Outputs go to ``{output_dir}/cyclegan_{direction}/name`` or
    ``{output_dir}/local_style_{mode}_{direction}/name``, as the reference
    lays them out. canvas: working resolution, a multiple of 32. engine:
    'auto' (the default, as in the JAX package) resolves through
    :func:`select_engine` on the final batch size, after the small-folder
    shrink and the rounding to the device count; 'nhwc', 'packed' or
    'int8' force one (see make_batch_fn). 'int8' prints its EXPERIMENTAL
    warning and calibrates an enhanced model on the folder's first
    CALIBRATION_IMAGES images decoded at the run's canvas; a plain model
    runs its own forward under any engine (make_batch_fn). A build,
    calibration or launch failure raises: there is no fallback engine and
    no fallback calibration batch (the JAX package degrades to nhwc and to
    its synthetic batch).

    devices: each device (a device may repeat) holds a replica of the
    program and takes one block of every batch, whose size is rounded up
    to a multiple of their count (JAX's pipelines/batch.py:286-294).
    """
    if (device is None) == (devices is None):
        raise TypeError("batch_process takes one of device= and devices=")
    devices = [torch.device(d) for d in
               (devices if devices is not None else [device])]
    if not devices:
        raise ValueError("devices is empty")
    if canvas % 32:
        raise ValueError(f"canvas must be a multiple of 32, got {canvas}")
    files = list_images(input_dir)
    if not files:
        print(f"error: no images found in {input_dir}")
        return {"processed": 0, "elapsed": 0.0}

    sub = (f"cyclegan_{direction}" if mode == "cyclegan"
           else f"local_style_{local_style_mode}_{direction}")
    out_dir = os.path.join(output_dir, sub)
    os.makedirs(out_dir, exist_ok=True)

    # Small folders: shrink the batch to the next power of two so a
    # 3-image run does not pay a 64-wide padded forward (the tail batch
    # pads by repeating its last image).
    pow2 = 1
    while pow2 < min(batch_size, len(files)):
        pow2 *= 2
    batch_size = min(batch_size, pow2)
    n_dev = len(devices)
    if n_dev > 1:
        # the shrunk batch must still divide over the devices
        batch_size = ((max(batch_size, n_dev) + n_dev - 1) // n_dev) * n_dev
        print(f"data-parallel: {n_dev} replicas, "
              f"{batch_size // n_dev} images each of a batch of {batch_size}")
    if engine == "auto":
        engine = select_engine(batch_size, canvas, model.kind)
        print(f"engine=auto -> {engine} (batch {batch_size}, "
              f"canvas {canvas})")
    elif engine == "int8":
        print(EXPERIMENTAL_WARNING)
    calib = None
    if engine == "int8" and model.kind == "enhanced":
        # activation scales from the folder's own first images at the run's
        # canvas, not a synthetic batch (a plain model runs its own forward)
        head = np.stack([_decode_canvas(f, canvas)[0]
                         for f in files[:CALIBRATION_IMAGES]])
        calib = [to_model_range(torch.from_numpy(head)).numpy()]
    run_fns = [make_batch_fn(model, mode, local_style_mode, strength, detail,
                             enhance_colors, smooth,
                             compute_dtype=compute_dtype, engine=engine,
                             calib_batches=calib, device=d) for d in devices]
    use_native = _native.available()
    n_failed = 0

    def batches():
        nonlocal n_failed
        for i in range(0, len(files), batch_size):
            chunk = files[i:i + batch_size]
            arr, sizes, ok = _decode_batch(chunk, canvas, decode_workers)
            if not ok.all():
                n_failed += int((~ok).sum())
                keep = np.flatnonzero(ok)
                if keep.size == 0:
                    continue
                chunk = [chunk[j] for j in keep]
                sizes = [sizes[j] for j in keep]
                arr = arr[keep]
            if arr.shape[0] < batch_size:
                pad = batch_size - arr.shape[0]
                arr = np.concatenate([arr, np.repeat(arr[-1:], pad, 0)])
            yield chunk, sizes, [torch.from_numpy(block).to(d) for block, d
                                 in zip(np.split(arr, n_dev), devices)]

    def prefetched(gen):
        """Run ``gen`` (decode + host-to-device copy) on its own thread,
        at most PREFETCH_DEPTH batches ahead."""
        q = queue.Queue(maxsize=PREFETCH_DEPTH)
        done = object()

        def worker():
            try:
                for item in gen:
                    q.put(item)
                q.put(done)
            except BaseException as e:  # handed to the consumer, re-raised there
                q.put(e)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    saves = []
    save_pool = ThreadPoolExecutor(max_workers=decode_workers)
    fetch_pool = ThreadPoolExecutor(max_workers=1)  # in-order copies back

    def save_batch(host, chunk, sizes):
        """Encode one fetched batch; returns the count written."""
        out_paths = [os.path.join(out_dir, os.path.basename(f)) for f in chunk]
        done = 0
        todo = range(len(chunk))
        if use_native:
            # native aspect-crop + resize-back + encode; extensions it does
            # not write (BMP, ...) go through PIL below
            ok = _native.save_canvas_batch(host[:len(chunk)], sizes, out_paths,
                                           num_threads=decode_workers)
            done += int(ok.sum())
            todo = [j for j in todo if not ok[j]]
        for j in todo:
            _restore_and_save(host[j], sizes[j], out_paths[j], canvas)
            done += 1
        return done

    def drain(chunk, sizes, dev_outs):  # fetch_pool: one worker, in order
        # device-to-host; waits for the batch (every replica's block)
        host = (dev_outs[0].cpu().numpy() if n_dev == 1 else
                np.concatenate([o.cpu().numpy() for o in dev_outs]))
        saves.append(save_pool.submit(save_batch, host, chunk, sizes))

    t0 = time.perf_counter()
    try:
        drains = []
        for chunk, sizes, dev_blocks in prefetched(batches()):
            # queued on each replica's device
            dev_outs = [fn(x) for fn, x in zip(run_fns, dev_blocks)]
            drains.append(fetch_pool.submit(drain, chunk, sizes, dev_outs))
            if len(drains) > 2:  # bound the outputs in flight
                drains.pop(0).result()
        for d in drains:
            d.result()
        n_done = sum(s.result() for s in saves)
    finally:
        fetch_pool.shutdown(wait=True)
        save_pool.shutdown(wait=True)
    elapsed = time.perf_counter() - t0
    print(f"done: {n_done}/{len(files)} images in {elapsed:.2f}s "
          f"({n_done / max(elapsed, 1e-9):.2f} img/s, "
          f"{elapsed / max(n_done, 1):.3f}s per image)")
    return {"processed": n_done, "failed": n_failed, "elapsed": elapsed,
            "imgs_per_sec": n_done / max(elapsed, 1e-9), "out_dir": out_dir}
