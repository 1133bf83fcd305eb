"""Dense FFN: SwiGLU (llama family) or GELU (``repro.models.mlp``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.sharding import shard
from repro_torch.models.spec import ParamSpec


def mlp_spec(cfg: ArchConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "w_gate": ParamSpec((d, f), (None, "ff")),
            "w_up": ParamSpec((d, f), (None, "ff")),
            "w_down": ParamSpec((f, d), ("ff", None)),
        }
    return {
        "w_up": ParamSpec((d, f), (None, "ff")),
        "b_up": ParamSpec((f,), ("ff",), init="zeros"),
        "w_down": ParamSpec((f, d), ("ff", None)),
        "b_down": ParamSpec((d,), (None,), init="zeros"),
    }


def mlp_apply(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
              rules=None) -> torch.Tensor:
    dt = x.dtype
    if cfg.act == "swiglu":
        gate = torch.matmul(x, p["w_gate"].to(dt))
        up = torch.matmul(x, p["w_up"].to(dt))
        h = shard(F.silu(gate) * up, rules, "batch", None, "ff")
        y = torch.matmul(h, p["w_down"].to(dt))
    else:
        # jax.nn.gelu defaults to the tanh approximation.
        h = F.gelu(torch.matmul(x, p["w_up"].to(dt)) + p["b_up"].to(dt),
                   approximate="tanh")
        h = shard(h, rules, "batch", None, "ff")
        y = torch.matmul(h, p["w_down"].to(dt)) + p["b_down"].to(dt)
    return shard(y, rules, "batch", None, None)
