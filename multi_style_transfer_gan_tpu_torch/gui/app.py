"""Tkinter GUI application (port of the JAX package's ``gui/app.py``; the
reference's gan_login_gui.py, ~2700 lines of UI rebuilt on the
framework's pipelines).

Structure mirrors the reference: a login/register screen (users.json +
sha256, remember-me), then a notebook with four tabs
(gan_login_gui.py:443-496):

- 标准模式 standard: direction combo, blend presets (0/10/30/50% original),
  fix-color-blocks toggle, strength/smooth sliders, enhance colors
  (:498-992): runs the enhanced generator + the standard post chain.
- 局部风格 local style: simple/enhanced/advanced mode, strength + detail
  sliders, sky handling, smooth transitions (:994-1641).
- 原始CycleGAN: plain forward + aspect restore (:1643-1983).
- 对比模式 compare: enhanced (fixed detail=0.6 post chain) vs cyclegan side
  by side (:1985-2682).

Threading model matches the reference: daemon worker threads +
``root.after`` marshaling + an ``is_processing`` reentrancy flag
(:716-767). Models load once after login from the reference's fixed
paths under ./models (:119-278), tolerantly (a missing/still-loading
model surfaces a clear error dialog from its tab instead of crashing
the app). The tab workers are module functions, so the whole
image -> model -> post chain -> save path runs without a display; they
run on the model's device, and the post chains in fp32 there.

Run: ``python -m multi_style_transfer_gan_tpu_torch.gui.app`` (needs a
display and a CUDA device; ``MSTGAN_GUI_PRECISION`` = default | high |
highest | int8 picks the generators' precision; int8, the EXPERIMENTAL
post-training-quantized engine, serves the enhanced models, and the plain
CycleGAN pair loads at the default precision).
"""

from __future__ import annotations

import os
import sys
import threading

import numpy as np
import torch

from . import auth

MODELS_DIR = "models"
OUTPUT_DIR = "output"
DEVICE = "cuda"   # tests run the workers on the CPU by passing device="cpu"
MODEL_ATTRS = ("enhanced_ab", "enhanced_ba", "cyclegan_ab", "cyclegan_ba")


class ModelManager:
    """Loads the up-to-4 models the GUI uses (gan_login_gui.py:119-278) onto
    ``device``."""

    def __init__(self, models_dir=MODELS_DIR, precision="default", *,
                 device):
        # precision: 'default' and 'high' let cuDNN take TF32 on the card;
        # 'highest' turns it off (the JAX package's torch-parity setting);
        # 'int8' serves the enhanced models through the int8 engine, and
        # the plain CycleGAN pair at 'default'
        from ..pipelines.model_loader import PRECISIONS

        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, "
                             f"got {precision!r}")
        self.models_dir = models_dir
        self.precision = precision
        self.device = device
        self.enhanced_ab = None
        self.enhanced_ba = None
        self.cyclegan_ab = None
        self.cyclegan_ba = None

    def load(self, log=print):
        from ..pipelines import load_generator
        from ..weights import detect_model_kind, extract_state_dict, load_pth

        paths = {
            "enhanced_ab": ("G_AB_epoch_200.pth", None),
            "enhanced_ba": ("G_BA_epoch_200.pth", None),
            "cyclegan_ab": ("cyclegan_epoch_200.pth", "G_AB_state_dict"),
            "cyclegan_ba": ("cyclegan_epoch_200.pth", "G_BA_state_dict"),
        }
        for attr, (name, prefer) in paths.items():
            path = os.path.join(self.models_dir, name)
            if not os.path.exists(path):
                log(f"model missing: {path}")
                continue
            try:
                precision = self.precision
                if precision == "int8" and detect_model_kind(
                        extract_state_dict(load_pth(path),
                                           prefer=prefer)) != "enhanced":
                    # int8 takes enhanced models only: a plain checkpoint
                    # loads at 'default' (JAX's gui/app.py:73)
                    precision = "default"
                m = load_generator(path, prefer=prefer, precision=precision,
                                   device=self.device)
                setattr(self, attr, m)
                log(f"loaded {attr} from {name} (precision={m.precision})")
            except Exception as e:  # tolerant like the reference (:214-245)
                log(f"failed to load {attr}: {e}")

    def loaded(self) -> int:
        """How many of the four models are loaded."""
        return sum(getattr(self, a) is not None for a in MODEL_ATTRS)

    def pick(self, family: str, direction: str):
        """family in {enhanced, cyclegan}; direction photo2monet/monet2photo.

        Raises a clear error while the model is still loading or its file is
        missing (surfaced as the worker's error dialog) instead of letting
        workers crash on None.apply."""
        suffix = "ba" if direction == "photo2monet" else "ab"
        model = getattr(self, f"{family}_{suffix}")
        if model is None:
            raise RuntimeError(
                f"{family} model for {direction} is not loaded (still "
                f"loading, or missing from {self.models_dir}/)")
        return model


def _styled_canvas(model, img_path):
    """Decode onto the white 256 canvas and run the generator: (canvas, the
    styled canvas in uint8 scale, (w, h)), both (256, 256, 3) fp32 on the
    model's device."""
    from ..ops import from_model_range, to_model_range
    from ..pipelines.batch import _decode_canvas

    canvas, wh = _decode_canvas(img_path, 256, 255)
    canvas = torch.from_numpy(np.array(canvas)).to(model.device)
    styled = from_model_range(model.apply(to_model_range(canvas)[None]))[0]
    return canvas.float(), styled * 255.0, wh


def _boost_colors(img_u8f, direction):
    """The tabs' colour boost (:861-872, :1410-1418): photo2monet scales B by
    1.1 and G by 1.05, uint8-saturating; monet2photo convertScaleAbs(1.1,
    5)."""
    from ..ops.filters import convert_scale_abs

    if direction == "photo2monet":
        gain = torch.tensor([1.0, 1.05, 1.1], device=img_u8f.device)
        return torch.clamp(img_u8f * gain, 0, 255)
    return convert_scale_abs(img_u8f, 1.1, 5)


def _process_standard(model, img_path, out_path, *, blend_original=0.0,
                      fix_blocks=False, strength=0.8, smooth=2,
                      enhance_colors=True, adaptive_smooth=True,
                      direction="photo2monet"):
    """Standard-tab worker chain (standard_process_thread, :769-907)."""
    from ..ops.filters import bilateral_filter, gaussian_blur, median_blur3
    from ..ops.smooth import fix_color_blocks

    canvas_f, styled, (w, h) = _styled_canvas(model, img_path)
    out = canvas_f * (1 - strength) + styled * strength
    if blend_original > 0:
        out = canvas_f * blend_original + out * (1 - blend_original)
    if fix_blocks:
        out = median_blur3(out)
        out = bilateral_filter(out, 9, 75, 75)
        out = fix_color_blocks(out, canvas_f)
    if enhance_colors:
        out = _boost_colors(out, direction)
    # smoothing is gated on BOTH the level and the adaptive-smooth toggle,
    # exactly like the reference (gan_login_gui.py:858-864)
    if adaptive_smooth and smooth > 0:
        out = gaussian_blur(out, 2 * int(smooth) + 1)
    return _finish_and_save(out, w, h, out_path)


def _finish_and_save(res, w, h, out_path):
    """Clamp, aspect-crop, restore original size (<=1MP), save: the shared
    tail of every GUI worker (gan_login_gui.py:874-899), through the batch
    pipeline's save helper so the recipe exists once."""
    from ..pipelines.batch import _restore_and_save

    out_u8 = torch.clamp(torch.round(res), 0, 255).to(torch.uint8)
    _restore_and_save(out_u8.cpu().numpy(), (w, h), out_path, 256)
    return out_path


def _process_local(model, img_path, out_path, *, mode="enhanced",
                   strength=0.5, detail=0.6, sky_handling=True,
                   enhance_colors=True, smooth_transitions=True,
                   direction="photo2monet"):
    """Local-style-tab worker (local_style_process_thread, :1259-1530).

    mode: simple/enhanced/advanced (the GUI blend recipes) or
    enhanced_segmentation (the full felzenszwalb pipeline, which draws its
    comparison figure). The toggles mirror the tab's checkboxes: sky
    handling (:1055-1057, gates the blue sky mask at :1334), enhance
    colors (:1410-1418: photo2monet channel boost, else convertScaleAbs),
    smooth transitions (:1421-1423: bilateral 9/75/75)."""
    from ..ops.filters import bilateral_filter
    from ..ops.gui_effects import gui_local_style_blend
    from ..pipelines.batch import _postprocess

    if mode == "enhanced_segmentation":
        from ..pipelines.local_style import enhanced_local_style_transfer

        enhanced_local_style_transfer(model, img_path, out_path)
        return out_path
    canvas_f, styled, (w, h) = _styled_canvas(model, img_path)
    if mode == "enhanced":
        # GUI-tab blend recipe (blue-sky mask + Canny edge weights,
        # gan_login_gui.py:1334-1408)
        res = gui_local_style_blend(
            canvas_f[None], styled[None], float(strength), float(detail),
            sky_handling=bool(sky_handling), direction=direction)[0]
        if enhance_colors:
            res = _boost_colors(res, direction)
        if smooth_transitions:
            res = bilateral_filter(res, 9, 75, 75)
    else:
        res = _postprocess(canvas_f[None], styled[None], mode,
                           float(strength), float(detail),
                           bool(enhance_colors), bool(smooth_transitions))[0]
    return _finish_and_save(res, w, h, out_path)


def _process_cyclegan(model, img_path, out_path):
    """CycleGAN-tab worker (cyclegan_process_thread, :1814-1898)."""
    _, styled, (w, h) = _styled_canvas(model, img_path)
    return _finish_and_save(styled, w, h, out_path)


def _thumb(path, max_side=380):
    """Tk-displayable thumbnail of an image file, or None (no display /
    no ImageTk). The reference shows originals and results in in-window
    canvases (gan_login_gui.py:2423-2638); this is our equivalent."""
    try:
        from PIL import Image, ImageTk

        img = Image.open(path)
        img.thumbnail((max_side, max_side))
        return ImageTk.PhotoImage(img)
    except Exception:
        return None


def model_info_text(manager) -> str:
    """The debug_check_model info panel (gan_login_gui.py:280-298): per
    model: load state, family, channel width, parameter count and
    top-level children. Pure text so it is testable headless. The counts
    are those of the JAX package's parameters: every state-dict tensor but
    BatchNorm's ``num_batches_tracked``."""
    lines = []
    for attr in MODEL_ATTRS:
        m = getattr(manager, attr)
        if m is None:
            lines.append(f"{attr}: NOT loaded")
            continue
        params = {k: v for k, v in m.module.state_dict().items()
                  if not k.endswith("num_batches_tracked")}
        n_params = sum(v.numel() for v in params.values())
        children = sorted({k.split(".")[0] for k in params})
        lines.append(f"{attr}: kind={m.kind}  channels={m.channels}  "
                     f"params={n_params:,}  tensors={len(params)}")
        lines.append(f"    children: {', '.join(children)}")
    return "\n".join(lines)


def main():
    """Start the GUI on the CUDA device. Returns an exit code: 2 for an
    unknown precision, 1 without a CUDA device (each before Tk is imported
    and a window opens)."""
    from ..pipelines.model_loader import PRECISIONS

    precision = os.environ.get("MSTGAN_GUI_PRECISION", "default")
    if precision not in PRECISIONS:
        print(f"error: MSTGAN_GUI_PRECISION={precision} is not one of "
              f"{PRECISIONS}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("error: no CUDA device; the port runs on the GPU",
              file=sys.stderr)
        return 1
    manager = ModelManager(precision=precision, device=DEVICE)

    import tkinter as tk
    from tkinter import filedialog, messagebox, ttk

    root = tk.Tk()
    root.title("Style transfer")
    root.geometry("1100x760")
    state = {"user": None, "busy": False}

    # ---------------- login frame ----------------
    login = ttk.Frame(root, padding=30)

    def show_login():
        for w in root.winfo_children():
            w.pack_forget()
        login.pack(expand=True)

    ttk.Label(login, text="Sign in", font=("", 16)).grid(row=0, columnspan=2,
                                                         pady=10)
    ttk.Label(login, text="username").grid(row=1, column=0, sticky="e")
    user_e = ttk.Entry(login)
    user_e.grid(row=1, column=1)
    ttk.Label(login, text="password").grid(row=2, column=0, sticky="e")
    pass_e = ttk.Entry(login, show="*")
    pass_e.grid(row=2, column=1)
    remember = tk.BooleanVar(value=False)
    ttk.Checkbutton(login, text="remember me", variable=remember).grid(
        row=3, column=1, sticky="w")
    status = ttk.Label(login, text="")
    status.grid(row=6, columnspan=2)

    def do_login():
        u, p = user_e.get(), pass_e.get()
        if auth.validate_login(u, p):
            if remember.get():
                auth.save_credentials(u, p)
            state["user"] = u
            show_app()
        else:
            status.config(text="invalid username or password")

    def do_register():
        ok, msg = auth.register_user(user_e.get(), pass_e.get())
        status.config(text=msg)

    ttk.Button(login, text="login", command=do_login).grid(row=4, column=0,
                                                           pady=8)
    ttk.Button(login, text="register", command=do_register).grid(row=4,
                                                                 column=1)

    # ---------------- main app ----------------
    def show_app():
        for w in root.winfo_children():
            w.pack_forget()
        nb = ttk.Notebook(root)
        nb.pack(fill="both", expand=True)

        # app-wide model status bar + async load (the reference logs load
        # progress to the console; we surface it in-window)
        load_status = ttk.Label(root, text="loading models…",
                                anchor="w", padding=(8, 2))
        load_status.pack(fill="x", side="bottom")
        load_log = []

        def on_load_msg(msg):
            load_log.append(msg)
            root.after(0, lambda: load_status.config(text=msg))

        def load_models():
            manager.load(log=on_load_msg)
            on_load_msg(f"models ready: {manager.loaded()}/4 loaded")

        threading.Thread(target=load_models, daemon=True).start()

        def show_model_info():
            """debug_check_model parity: per-model info in a window."""
            top = tk.Toplevel(root)
            top.title("model info")
            txt = tk.Text(top, width=90, height=16, wrap="none")
            txt.insert("1.0", model_info_text(manager) + "\n\nload log:\n"
                       + "\n".join(load_log))
            txt.config(state="disabled")
            txt.pack(fill="both", expand=True)

        class ScrollPanels:
            """Scrollable row of captioned images — the reference's
            side-by-side result canvases (setup_compare_tab,
            gan_login_gui.py:1985-2218): results render in-window inside
            a canvas with scrollbars rather than only as saved files."""

            def __init__(self, parent, row, height=430):
                self.canvas = tk.Canvas(parent, height=height,
                                        highlightthickness=0)
                hbar = ttk.Scrollbar(parent, orient="horizontal",
                                     command=self.canvas.xview)
                vbar = ttk.Scrollbar(parent, orient="vertical",
                                     command=self.canvas.yview)
                self.canvas.configure(xscrollcommand=hbar.set,
                                      yscrollcommand=vbar.set)
                self.canvas.grid(row=row, column=0, columnspan=4,
                                 sticky="nsew", pady=8)
                hbar.grid(row=row + 1, column=0, columnspan=4, sticky="ew")
                vbar.grid(row=row, column=4, sticky="ns")
                parent.grid_rowconfigure(row, weight=1)
                for c in range(4):
                    parent.grid_columnconfigure(c, weight=1)
                self.inner = ttk.Frame(self.canvas)
                self.canvas.create_window((0, 0), window=self.inner,
                                          anchor="nw")
                self.inner.bind("<Configure>", lambda e: self.canvas.config(
                    scrollregion=self.canvas.bbox("all")))

            def show(self, items):
                """items: [(caption, path)] rendered left-to-right."""
                for w in self.inner.winfo_children():
                    w.destroy()
                for col, (caption, path) in enumerate(items):
                    ttk.Label(self.inner, text=caption).grid(
                        row=0, column=col, padx=6)
                    ph = _thumb(path)
                    if ph is not None:
                        lbl = ttk.Label(self.inner, image=ph)
                        lbl.image = ph  # keep a ref or Tk drops it
                        lbl.grid(row=1, column=col, padx=6, pady=4)
                    else:
                        ttk.Label(self.inner, text=path).grid(
                            row=1, column=col, padx=6)

        def make_tab(title, runner, controls):
            """runner(path, cfg) returns an output path, or a list of
            (caption, path) panels to display (compare tab)."""
            frame = ttk.Frame(nb, padding=10)
            nb.add(frame, text=title)
            sel = {"path": None}
            img_label = ttk.Label(frame, text="no image selected")
            img_label.grid(row=0, column=0, columnspan=4, pady=4)
            panels = ScrollPanels(frame, row=5)
            prog = ttk.Progressbar(frame, mode="indeterminate", length=300)
            prog.grid(row=99, column=0, columnspan=4, pady=8)
            # per-tab status line (the reference keeps one per tab)
            tab_status = ttk.Label(frame, text="ready", anchor="w")
            tab_status.grid(row=100, column=0, columnspan=4, sticky="ew")

            def choose():
                p = filedialog.askopenfilename(filetypes=[
                    ("images", "*.jpg *.jpeg *.png *.bmp")])
                if p:
                    sel["path"] = p
                    img_label.config(text=os.path.basename(p))
                    panels.show([("original", p)])
                    tab_status.config(text=f"selected {p}")

            def run():
                if state["busy"]:
                    messagebox.showinfo("busy", "processing in progress")
                    return
                if not sel["path"]:
                    messagebox.showwarning("no image", "choose an image first")
                    return
                state["busy"] = True
                prog.start(10)
                tab_status.config(text="processing…")
                # snapshot Tk variables on the MAIN thread — Variable.get()
                # talks to the Tcl interpreter and is not thread-safe
                cfg = {k: v.get() for k, v in controls.items()}

                def work():
                    try:
                        out = runner(sel["path"], cfg)

                        def done(out=out):
                            if isinstance(out, list):
                                items, saved = out, out[-1][1]
                            else:
                                items = [("original", sel["path"]),
                                         ("result", out)]
                                saved = out
                            panels.show(items)
                            tab_status.config(text=f"saved: {saved}")

                        root.after(0, done)
                    except Exception as e:
                        def fail(e=e):
                            tab_status.config(text=f"error: {e}")
                            messagebox.showerror("error", str(e))

                        root.after(0, fail)
                    finally:
                        state["busy"] = False
                        root.after(0, prog.stop)

                threading.Thread(target=work, daemon=True).start()

            ttk.Button(frame, text="choose image", command=choose).grid(
                row=1, column=0, pady=4)
            ttk.Button(frame, text="generate", command=run).grid(
                row=1, column=1)
            ttk.Button(frame, text="model info",
                       command=show_model_info).grid(row=1, column=2)
            return frame

        # standard tab
        std_controls = {}
        std_frame = make_tab("standard", lambda p, c: _process_standard(
            manager.pick("enhanced", c["direction"]), p,
            os.path.join(OUTPUT_DIR, f"standard_{os.path.basename(p)}"),
            blend_original=float(c["blend"]) / 100.0,
            fix_blocks=bool(c["fix"]), strength=float(c["strength"]),
            smooth=int(float(c["smooth"])), enhance_colors=bool(c["colors"]),
            adaptive_smooth=bool(c["adaptive"]),
            direction=c["direction"]), std_controls)
        std_controls["direction"] = tk.StringVar(value="photo2monet")
        ttk.Combobox(std_frame, textvariable=std_controls["direction"],
                     values=["photo2monet", "monet2photo"]).grid(row=2,
                                                                 column=0)
        std_controls["blend"] = tk.StringVar(value="0")
        ttk.Combobox(std_frame, textvariable=std_controls["blend"],
                     values=["0", "10", "30", "50"]).grid(row=2, column=1)
        std_controls["strength"] = tk.DoubleVar(value=0.8)
        ttk.Scale(std_frame, from_=0.2, to=1.0,
                  variable=std_controls["strength"]).grid(row=3, column=0)
        std_controls["smooth"] = tk.DoubleVar(value=2)
        ttk.Scale(std_frame, from_=0, to=7,
                  variable=std_controls["smooth"]).grid(row=3, column=1)
        std_controls["fix"] = tk.BooleanVar(value=False)
        ttk.Checkbutton(std_frame, text="fix color blocks",
                        variable=std_controls["fix"]).grid(row=4, column=0)
        std_controls["colors"] = tk.BooleanVar(value=True)
        ttk.Checkbutton(std_frame, text="enhance colors",
                        variable=std_controls["colors"]).grid(row=4, column=1)
        std_controls["adaptive"] = tk.BooleanVar(value=True)
        ttk.Checkbutton(std_frame, text="adaptive smooth",
                        variable=std_controls["adaptive"]).grid(row=4,
                                                                column=2)

        # local style tab
        def run_local(p, c):
            return _process_local(
                manager.pick("enhanced", c["direction"]), p,
                os.path.join(OUTPUT_DIR, f"local_{os.path.basename(p)}"),
                mode=c["mode"], strength=float(c["strength"]),
                detail=float(c["detail"]), sky_handling=bool(c["sky"]),
                enhance_colors=bool(c["colors"]),
                smooth_transitions=bool(c["smooth"]),
                direction=c["direction"])

        ls_controls = {}
        ls_frame = make_tab("local style", run_local, ls_controls)
        ls_controls["direction"] = tk.StringVar(value="photo2monet")
        ttk.Combobox(ls_frame, textvariable=ls_controls["direction"],
                     values=["photo2monet", "monet2photo"]).grid(row=2,
                                                                 column=0)
        ls_controls["mode"] = tk.StringVar(value="enhanced")
        ttk.Combobox(ls_frame, textvariable=ls_controls["mode"],
                     values=["simple", "enhanced", "advanced",
                             "enhanced_segmentation"]).grid(row=2, column=1)
        ls_controls["strength"] = tk.DoubleVar(value=0.5)
        ttk.Scale(ls_frame, from_=0.2, to=1.0,
                  variable=ls_controls["strength"]).grid(row=3, column=0)
        ls_controls["detail"] = tk.DoubleVar(value=0.6)
        ttk.Scale(ls_frame, from_=0.3, to=0.9,
                  variable=ls_controls["detail"]).grid(row=3, column=1)
        ls_controls["sky"] = tk.BooleanVar(value=True)
        ttk.Checkbutton(ls_frame, text="sky handling",
                        variable=ls_controls["sky"]).grid(row=4, column=0)
        ls_controls["colors"] = tk.BooleanVar(value=True)
        ttk.Checkbutton(ls_frame, text="enhance colors",
                        variable=ls_controls["colors"]).grid(row=4, column=1)
        ls_controls["smooth"] = tk.BooleanVar(value=True)
        ttk.Checkbutton(ls_frame, text="smooth transitions",
                        variable=ls_controls["smooth"]).grid(row=4, column=2)

        # cyclegan tab
        def run_cyc(p, c):
            return _process_cyclegan(
                manager.pick("cyclegan", c["direction"]), p,
                os.path.join(OUTPUT_DIR, f"cyclegan_{os.path.basename(p)}"))

        cyc_controls = {}
        cyc_frame = make_tab("cyclegan", run_cyc, cyc_controls)
        cyc_controls["direction"] = tk.StringVar(value="photo2monet")
        ttk.Combobox(cyc_frame, textvariable=cyc_controls["direction"],
                     values=["photo2monet", "monet2photo"]).grid(row=2,
                                                                 column=0)

        # compare tab — original + both results side by side in the
        # scrollable canvas (reference compare_process_thread :2423-2638)
        def run_cmp(p, c):
            from ..pipelines.compare import compare_models
            enh = manager.pick("enhanced", c["direction"])
            cyc = manager.pick("cyclegan", c["direction"])
            out = compare_models(enh, cyc, p, OUTPUT_DIR)
            return [("original", p),
                    ("enhanced local-style", out["enhanced"]),
                    ("cyclegan", out["cyclegan"]),
                    ("side-by-side figure", out["figure"])]

        cmp_controls = {}
        cmp_frame = make_tab("compare", run_cmp, cmp_controls)
        cmp_controls["direction"] = tk.StringVar(value="photo2monet")
        ttk.Combobox(cmp_frame, textvariable=cmp_controls["direction"],
                     values=["photo2monet", "monet2photo"]).grid(row=2,
                                                                 column=0)

    remembered = auth.load_credentials()
    if remembered:
        state["user"] = remembered
        show_app()
    else:
        show_login()
    root.mainloop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
