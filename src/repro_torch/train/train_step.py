"""Train step: microbatched gradient accumulation, clipping, optimizer.

Twin of ``repro.train.train_step.make_train_step`` on one device.  The
dropout pattern (dp, bias) is bound when the step is made, as the reference
bakes it into one compiled executable per bucket; the trainer keeps one
step per bucket.  The pattern applies to both passes: autograd runs through
the pattern FFNs, and every backend keeps the backward products compact
("slice"/"gather" through PyTorch's adjoints of the strided slice and
index_select, "cuda"/"fused" through the backward kernels).

The global batch splits into ``microbatches`` chunks run one after the
other; their gradients are cast to f32 and averaged in f32.  TernGrad
compression (``compress_grads``) comes with distributed training.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.transformer import ModelConfig, lm_loss
from ..optim.optimizers import clip_by_global_norm
from ..tree import tree_leaves, tree_map


def to_device(batch: dict, device) -> dict:
    """numpy (or tensor) token arrays → int64 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device=device, dtype=torch.int64)
            for k, v in batch.items()}


def _split_micro(batch: dict, m: int) -> list[dict]:
    return [{k: v[i * (v.shape[0] // m):(i + 1) * (v.shape[0] // m)]
             for k, v in batch.items()} for i in range(m)]


def make_train_step(cfg: ModelConfig, optimizer, *, microbatches: int = 1,
                    pat=None, clip_norm: float = 1.0,
                    compress_grads: bool = False, device=None):
    """Return ``train_step(params, opt_state, batch, lr) -> (params,
    opt_state, {"loss", "grad_norm"})`` on ``device`` (the GPU unless
    given).  ``batch`` holds numpy or tensor ``tokens``/``labels``; the
    parameters and optimizer state are updated in place and returned."""
    dev = resolve_device(device)
    if compress_grads:
        raise NotImplementedError("compress_grads (TernGrad) is not ported "
                                  "yet: it comes with distributed training")

    def grad_fn(params, mb):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = lm_loss(cfg, params, mb, pat)
        grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        return loss.detach(), tree_map(lambda _p: next(it).float(), params)

    def train_step(params, opt_state, batch, lr):
        batch = to_device(batch, dev)
        if microbatches > 1:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for mb in _split_micro(batch, microbatches):
                mloss, mgrads = grad_fn(params, mb)
                grads = tree_map(lambda a, g: a + g / microbatches, grads,
                                 mgrads)
                loss = loss + mloss / microbatches
        else:
            loss, grads = grad_fn(params, batch)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        params, opt_state = optimizer.update(params, grads, opt_state, lr)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
