"""InceptionV3, the FID variant, for feature extraction on the card
(counterpart of ``salun/evalx/inception.py``).

The network is pytorch-fid's ``pt_inception-2015-12-05`` one: InceptionA/C/E
average pools with ``count_include_pad=False``, the last E block with a
3×3 stride-1 max pool, BatchNorm at eps 1e-3 on its running statistics,
and a 1,008-way ``fc``. Module names are pytorch-fid's
(``Conv2d_1a_3x3.conv``, ``Mixed_5b.branch1x1.bn``, …, ``fc``), so its
weight file loads with ``load_state_dict`` (:func:`load_params` reads a
local file and never fetches). Without weights the network runs on a
seeded random init (a pipeline check only).

Input: NCHW float in [0, 1], any size, resized to 299×299 inside
(bilinear, half-pixel centres, antialiased when it shrinks, as
``jax.image.resize`` is), then scaled to [−1, 1]. Outputs: the 2,048-d
pool, the sFID spatial feature (channels ``[:7]`` of the ``Mixed_6d``
output, flattened in (H, W, C) order, as the JAX package flattens its
NHWC tensor; DDPM/evaluator.py:36,659-666) and the softmax of ``fc``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NUM_CLASSES = 1008  # the TF graph's 1,008-way softmax
RESIZE = 299


class BasicConv2d(nn.Module):
    """conv (no bias) → BatchNorm(eps 1e-3, running statistics) → ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        bn = self.bn
        x = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var,
                         bn.weight, bn.bias, False, 0.0, bn.eps)
        return F.relu(x)


def _avg_pool_nocount(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


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
        bp = self.branch_pool(_avg_pool_nocount(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


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
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_nocount(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


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
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """``pool_kind`` "avg" (Mixed_7b, count_include_pad=False) or "max"
    (Mixed_7c, 3×3 stride 1, padding 1)."""

    def __init__(self, cin: int, pool_kind: str = "avg"):
        super().__init__()
        if pool_kind not in ("avg", "max"):
            raise ValueError(pool_kind)
        self.pool_kind = pool_kind
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
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        bp = (_avg_pool_nocount(x) if self.pool_kind == "avg"
              else F.max_pool2d(x, 3, 1, 1))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)],
                         1)


def resize_299(x: torch.Tensor) -> torch.Tensor:
    """NCHW → NCHW at 299×299: bilinear with half-pixel centres, the
    triangle widened when it shrinks (``jax.image.resize(..., "bilinear")``
    with its default antialiasing)."""
    return F.interpolate(x, size=(RESIZE, RESIZE), mode="bilinear",
                         align_corners=False, antialias=True)


class InceptionV3(nn.Module):
    """FID-variant InceptionV3; ``forward(x)`` returns (pool, spatial,
    softmax) for NCHW images in [0, 1]."""

    def __init__(self, num_classes: int = NUM_CLASSES):
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
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        b = x.shape[0]
        x = 2.0 * resize_299(x.to(torch.float32)) - 1.0  # TF scaling
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d"):
            x = getattr(self, name)(x)
        # the sFID tap: TF ``mixed_6/conv:0`` [..., :7] = the first 7
        # channels of the Mixed_6d output (salun/evalx/inception.py:176-186)
        spatial = x[:, :7].permute(0, 2, 3, 1).reshape(b, -1)
        for name in ("Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        pool = x.mean(dim=(2, 3))
        return pool, spatial, torch.softmax(self.fc(pool), dim=-1)


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """A local pytorch-fid ``pt_inception-2015-12-05-*.pth`` state dict."""
    return torch.load(path, map_location="cpu", weights_only=True)


def build_inception(weights: Optional[str] = None, device="cpu",
                    seed: int = 0) -> InceptionV3:
    """The network on ``device`` in eval mode: ``weights`` (a local
    pytorch-fid file) loaded strictly, or a seeded init: He-normal
    convolutions (fan-in, ReLU gain) over BatchNorm at its initial
    statistics, so that the features keep their scale through the 48
    layers (PyTorch's default init shrinks them ~2²⁴-fold there)."""
    torch.manual_seed(seed)
    model = InceptionV3()
    if weights:
        model.load_state_dict(load_params(weights), strict=True)
    else:
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, nonlinearity="relu")
    return model.to(device).eval()


def state_dict_from_flax(params: dict, batch_stats: dict
                         ) -> Dict[str, torch.Tensor]:
    """The JAX package's flax trees (numpy leaves) → this module's state
    dict: conv kernels HWIO → OIHW, ``fc`` (in, out) → (out, in), BatchNorm
    scale/bias/mean/var → weight/bias/running_mean/running_var."""
    out = {}

    def walk(tree, prefix, leaf_map):
        for k, v in tree.items():
            name = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, name, leaf_map)
                continue
            a = np.asarray(v, np.float32)
            if k == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            out[f"{prefix}.{leaf_map[k]}"] = torch.from_numpy(
                np.ascontiguousarray(a))

    walk(params, "", {"kernel": "weight", "scale": "weight", "bias": "bias"})
    walk(batch_stats, "", {"mean": "running_mean", "var": "running_var"})
    return out


def make_feature_fn(model: InceptionV3, batch_size: int = 64):
    """``extract(images)``: NHWC float images in [0, 1] (numpy) →
    (pool, spatial, softmax) numpy arrays, batched on the model's device."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def extract(images: np.ndarray):
        pools, spatials, smax = [], [], []
        for i in range(0, len(images), batch_size):
            x = torch.from_numpy(np.ascontiguousarray(
                images[i:i + batch_size], np.float32)).to(device)
            p, s, m = model(x.permute(0, 3, 1, 2))
            pools.append(p.cpu().numpy())
            spatials.append(s.cpu().numpy())
            smax.append(m.cpu().numpy())
        return (np.concatenate(pools), np.concatenate(spatials),
                np.concatenate(smax))

    return extract
