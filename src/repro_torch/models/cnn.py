"""Paper-native CNN families (port of ``repro.models.cnn``): AlexNet-style
sequential convs, ResNet bottleneck residuals, Inception-ResNet parallel
branches on residuals.

Activations are NCHW and conv weights OIHW (the reference: NHWC and HWIO);
``fc1``/``fc2`` stay (in, out).  Every conv is stride 1 with "SAME" padding
over an odd kernel (1, 3 or 5), so ``padding=k // 2``; the pool is the
reference's 2x2 VALID max ``reduce_window``, which floors an odd size (299
-> 149) as ``F.max_pool2d(x, 2)`` does.  f32, the reference's dtype;
nothing here picks a device: the tensors' device decides.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.paper_native import CNNConfig
from ..optim.sgd import sgd_step


def _conv(x, w):
    return F.conv2d(x, w, padding=w.shape[-1] // 2)


def _pool(x, k: int = 2):
    return F.max_pool2d(x, k)


def init_cnn(cfg: CNNConfig, generator: torch.Generator) -> dict:
    """The reference's parameter dict (its keys, its scales: 1/sqrt(9 cin)
    for every conv, 0.01 for the fc layers), drawn from ``generator`` on
    its device.  The draws are not the reference's (no JAX key is
    replayed): ``cnn_params_from_jax`` bridges its init."""
    def normal(scale, *shape):
        return scale * torch.randn(shape, generator=generator, device=generator.device)
    params = {}
    cin = 3
    for si, (blocks, ch) in enumerate(cfg.stages):
        for bi in range(blocks):
            scale = 1.0 / math.sqrt(3 * 3 * cin)
            name = f"s{si}b{bi}"
            if cfg.inception:
                params[f"{name}_a"] = normal(scale, ch // 4, cin, 1, 1)
                params[f"{name}_b"] = normal(scale, ch // 2, cin, 3, 3)
                params[f"{name}_c"] = normal(scale, ch // 4, cin, 5, 5)
            elif cfg.fc == 0:                      # resnet bottleneck
                params[f"{name}_1"] = normal(scale, ch // 4, cin, 1, 1)
                params[f"{name}_2"] = normal(scale, ch // 4, ch // 4, 3, 3)
                params[f"{name}_3"] = normal(scale, ch, ch // 4, 1, 1)
                if cin != ch:
                    params[f"{name}_p"] = normal(scale, ch, cin, 1, 1)
            else:                                  # alexnet-style
                params[name] = normal(scale, ch, cin, 3, 3)
            cin = ch
    if cfg.fc:
        params["fc1"] = normal(0.01, cin, cfg.fc)
        params["fc2"] = normal(0.01, cfg.fc, cfg.classes)
    else:
        params["fc2"] = normal(0.01, cin, cfg.classes)
    return params


def cnn_forward(params: dict, x, cfg: CNNConfig):
    """x: (B, 3, H, W) -> logits (B, classes)."""
    relu = torch.relu
    for si, (blocks, _) in enumerate(cfg.stages):
        for bi in range(blocks):
            name = f"s{si}b{bi}"
            if cfg.inception:
                y = torch.cat([relu(_conv(x, params[f"{name}_{b}"])) for b in "abc"],
                              dim=1)
                # the residual only where the widths match (not at a stage's
                # first block, which changes them)
                x = y if x.shape[1] != y.shape[1] else relu(x + y)
            elif cfg.fc == 0:
                h = relu(_conv(x, params[f"{name}_1"]))
                h = relu(_conv(h, params[f"{name}_2"]))
                h = _conv(h, params[f"{name}_3"])
                proj = params.get(f"{name}_p")
                x = relu((x if proj is None else _conv(x, proj)) + h)
            else:
                x = relu(_conv(x, params[name]))
        x = _pool(x)
    x = x.mean(dim=(2, 3))
    if "fc1" in params:
        x = relu(x @ params["fc1"])
    return x @ params["fc2"]


def cnn_loss(params: dict, x, labels, cfg: CNNConfig):
    """Mean ``-log_softmax(logits)[label]``; labels (B,) int64 or int32."""
    logp = torch.log_softmax(cnn_forward(params, x, cfg), dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def train_step_fn(cfg: CNNConfig, lr: float = 0.01):
    """``step(params, x, labels) -> (loss, new_params)``: plain SGD, the
    reference's.  The leaves of ``params`` must require grad, and those of
    ``new_params`` do."""
    def step(params, x, labels):
        return sgd_step(cnn_loss(params, x, labels, cfg), params, lr)
    return step

