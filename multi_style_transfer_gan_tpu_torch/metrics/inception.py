"""InceptionV3 pool features for FID (port of ``metrics/inception.py``).

The reference's FID takes torchvision's pretrained ``inception_v3`` pool
features (m_test.py:16-34). ``InceptionV3`` is that trunk as an
``nn.Module`` whose submodules carry torchvision's names
(``Conv2d_1a_3x3.conv.weight``, ``Mixed_6b.branch7x7_2.bn.running_var``,
...), so a torchvision ``state_dict()`` loads as it is once
``inception_from_torch_sd`` has dropped the head: BasicConv2d = conv
(bias=False) + eval BatchNorm (eps 1e-3) + ReLU; stem -> Mixed_5b..5d
(InceptionA) -> Mixed_6a (B) -> Mixed_6b..6e (C) -> Mixed_7a (D) ->
Mixed_7b, 7c (E) -> global mean -> (N, 2048). No weights ship with the
repository: ``make_inception_feature_fn`` takes a user's ``.pth``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import resize


def inception_from_torch_sd(sd) -> dict:
    """The trunk's state dict from a torchvision ``inception_v3`` one: the
    ``AuxLogits*`` and ``fc.*`` head and every ``num_batches_tracked``
    dropped, the rest as fp32 tensors (conv weights stay OIHW)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("AuxLogits") or k.startswith("fc.") \
                or k.endswith("num_batches_tracked"):
            continue
        out[k] = torch.as_tensor(v).float()
    return out


class _EvalBatchNorm(nn.Module):
    """BatchNorm in eval mode with torchvision's parameter and buffer names
    but no ``num_batches_tracked``: the trunk only ever normalizes with the
    running statistics, so the importer drops that counter and the module
    loads the result with ``strict=True``."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=self.eps)


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn = _EvalBatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool3(x):
    # torchvision's branch_pool: avg_pool2d(3, stride=1, padding=1) with the
    # default count_include_pad=True (border windows divide by 9)
    return F.avg_pool2d(x, 3, stride=1, padding=1)


def _max_pool(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg_pool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                     self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3,
                     self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          _max_pool(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(_avg_pool3(x))], 1)


class InceptionV3(nn.Module):
    """torchvision's ``inception_v3`` up to its global pool (no dropout,
    no head, no auxiliary classifier); NCHW in, (N, 2048) out."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool(x)))
        x = _max_pool(x)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d,
                      self.Mixed_6a, self.Mixed_6b, self.Mixed_6c,
                      self.Mixed_6d, self.Mixed_6e, self.Mixed_7a,
                      self.Mixed_7b, self.Mixed_7c):
            x = block(x)
        return x.mean(dim=(2, 3))


@contextlib.contextmanager
def _fp32_exact():
    """fp32 with TF32 off in cuDNN and in matrix products, restored after:
    features the card and the CPU agree on, the counterpart of the JAX
    package's choice of accuracy over speed for metrics."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def inception_pool_features(model: InceptionV3, imgs01: torch.Tensor):
    """(N, H, W, 3) in [0, 1] -> (N, 2048) pool features on the model's
    device.

    torchvision's pretrained semantics (m_test.py:28-34): a bilinear resize
    to 299, ImageNet normalization, then the model's own
    ``transform_input=True`` step, which compose to exactly ``2x - 1``.
    """
    dev = next(model.parameters()).device
    with torch.inference_mode(), _fp32_exact():
        x = resize(imgs01.to(dev, torch.float32), (299, 299),
                   method="bilinear")
        x = (2.0 * x - 1.0).permute(0, 3, 1, 2)
        return model(x.contiguous(memory_format=torch.channels_last))


def make_inception_feature_fn(weights_path, *, device):
    """A ``feature_fn`` for ``fid_harness.run_fid_eval`` from a torchvision
    ``inception_v3`` state dict ``.pth`` (bare, or inside a checkpoint
    container): (N, H, W, 3) in [0, 1] -> (N, 2048) numpy features, the
    trunk on ``device`` in ``channels_last``."""
    from ..weights import extract_state_dict, load_pth

    ckpt = load_pth(weights_path)
    sd = ckpt
    if isinstance(ckpt, dict) and "Conv2d_1a_3x3.conv.weight" not in ckpt:
        sd = extract_state_dict(ckpt)
    model = InceptionV3()
    model.load_state_dict(inception_from_torch_sd(sd), strict=True)
    model = model.to(device=device, memory_format=torch.channels_last).eval()

    def feature_fn(imgs01):
        return inception_pool_features(model, imgs01).cpu().numpy()

    return feature_fn
