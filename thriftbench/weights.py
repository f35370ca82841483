"""Seeded weights of one arm, made by the benchmark and handed to both sides.

The program under test receives them through ``LM(cfg, params=layout)``;
the plain reference draws them again from the same seed, layer by layer,
after the program's state is freed. Both draws run the same calls on the
same device, so they give the same bits.

Layout (the one ``LM`` takes)::

    {"embed": {"tok": (Vp, D)}, "final_norm": (D,), ["head": {"w": (D, Vp)}],
     "layers": [{name: tensor}, ...]}

with ``Vp`` the vocabulary rounded up to 256 and each layer's tensors under
the names its block type's file gives them (``blocks/<type>.py``). Every
matrix of a layer comes from one ``torch.randn`` call into one flat buffer
on the device, in the model's dtype, from a generator seeded by (seed, arm,
layer); each matrix is a view of that buffer scaled in place.

The draw: N(0, 1/fan_in) for every matrix and N(0, 0.02^2) for the
embedding, as the port's own initialiser draws them, except that the
matrices that write into the residual stream (``wo``, ``wd``, ``ewd``,
``w_out``) are scaled by 1/sqrt of the block file's ``residual_depth``: 2 L
in attention and MoE blocks (GPT-2's residual scaling), L in Mamba blocks
(mamba_ssm's ``rescale_prenorm_residual``); and ``b_dt`` is the inverse
softplus of dt ~ log-uniform [1e-3, 1e-1], Mamba's published dt
initialisation. Without
the residual scaling a 64-layer random Mamba stack amplifies a bf16
rounding as far as an fp8 one, and no comparison could tell them apart.
"""
from __future__ import annotations

import importlib
import math
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

OUT_MATRICES = ("wo", "wd", "ewd", "w_out")


def derived(model: Dict) -> Dict:
    """The sizes a configuration leaves to their defaults, worked out as the
    published configurations define them, and each layer's block type: the
    model's ``layer_types`` where it lists them, else ``block_pattern``
    cycled over ``num_layers``."""
    m = dict(model)
    if not m.get("head_dim") and m.get("num_heads"):
        m["head_dim"] = m["d_model"] // m["num_heads"]
    if m.get("ssm_state") and not m.get("ssm_dt_rank"):
        m["ssm_dt_rank"] = math.ceil(m["d_model"] / 16)
    m["d_inner"] = m.get("ssm_expand", 2) * m["d_model"]
    m["vocab_padded"] = -(-m["vocab_size"] // 256) * 256
    types = m.get("layer_types")
    if types is None:
        pat = list(m["block_pattern"])
        types = [pat[i % len(pat)] for i in range(m["num_layers"])]
    if len(types) != m["num_layers"]:
        raise ValueError(f"layer_types lists {len(types)} layers, num_layers is {m['num_layers']}")
    m["layer_types"] = list(types)
    return m


def find_module(package: str, name: str, what: str):
    """The module ``<package>.<name>``: the one file of the benchmark that
    holds ``what`` ``name``, found by that name."""
    full = f"{package}.{name}"
    if name.isidentifier():
        try:
            return importlib.import_module(full)
        except ModuleNotFoundError as e:
            if e.name != full:
                raise
    where = Path(importlib.import_module(package).__path__[0]) / f"{name}.py"
    raise ValueError(f"{what} {name!r} has no file: {where} is missing")


def load_block(btype: str):
    """The module of ``blocks/<btype>.py``: the draw, the reference, the FLOPs
    and the kernel launches of one layer of that type."""
    return find_module("thriftbench.blocks", btype, "block type")


def layer_spec(m: Dict, btype: str) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """(name, shape, kind, fan_in) of every tensor of one layer, in draw
    order. ``kind`` is ``mat`` (a drawn matrix), ``zeros``, ``ones``,
    ``a_log`` or ``b_dt``."""
    return load_block(btype).spec(m)


def _gen_seed(seed: int, arm: int, slot: int) -> int:
    """A 64-bit generator seed for (run seed, arm, layer slot)."""
    ss = np.random.SeedSequence(int(seed), spawn_key=(int(arm), int(slot)))
    lo, hi = ss.generate_state(2, np.uint32)
    return (int(hi) << 32 | int(lo)) & ((1 << 63) - 1)


def _generator(device: torch.device, seed: int, arm: int, slot: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(_gen_seed(seed, arm, slot))
    return gen


def draw_layer(model: Dict, i: int, seed: int, arm: int, device) -> Dict[str, torch.Tensor]:
    """Layer ``i`` of arm ``arm``: its tensors by name, on ``device``."""
    m = derived(model)
    dev = torch.device(device)
    dtype = getattr(torch, m["dtype"])
    block = load_block(m["layer_types"][i])
    spec = block.spec(m)
    gen = _generator(dev, seed, arm, i)
    total = sum(math.prod(s) for _, s, k, _ in spec if k == "mat")
    flat = torch.randn(total, generator=gen, device=dev, dtype=dtype)
    depth = block.residual_depth(m)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, kind, fan_in in spec:
        if kind == "mat":
            n = math.prod(shape)
            t = flat[at:at + n].view(shape)
            at += n
            std = 1.0 / math.sqrt(fan_in)
            if name in OUT_MATRICES:
                std /= math.sqrt(depth)
            out[name] = t.mul_(std)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, dtype=torch.float32, device=dev)
        elif kind == "ones":
            out[name] = torch.ones(shape, dtype=torch.float32, device=dev)
        elif kind == "a_log":
            a = torch.arange(1, shape[1] + 1, dtype=torch.float32, device=dev)
            out[name] = torch.log(a).expand(shape).contiguous()
        elif kind == "b_dt":
            u = torch.rand(shape, generator=gen, dtype=torch.float32, device=dev)
            dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
            out[name] = dt + torch.log(-torch.expm1(-dt))            # softplus^-1(dt)
    return out


def draw_ends(model: Dict, seed: int, arm: int, device) -> Dict[str, torch.Tensor]:
    """The embedding, the final norm and (untied) the head of arm ``arm``."""
    m = derived(model)
    dev = torch.device(device)
    dtype = getattr(torch, m["dtype"])
    V, D, L = m["vocab_padded"], m["d_model"], m["num_layers"]
    gen = _generator(dev, seed, arm, L)
    out = {"tok": torch.randn((V, D), generator=gen, device=dev, dtype=dtype).mul_(0.02),
           "final_norm": torch.zeros((D,), dtype=torch.float32, device=dev)}
    if not m["tie_embeddings"]:
        gen = _generator(dev, seed, arm, L + 1)
        out["head"] = torch.randn((D, V), generator=gen, device=dev,
                                  dtype=dtype).mul_(1.0 / math.sqrt(D))
    return out


def draw_arm(model: Dict, seed: int, arm: int, device) -> Dict:
    """The whole arm in the layout ``LM(cfg, params=...)`` takes."""
    ends = draw_ends(model, seed, arm, device)
    layout = {"embed": {"tok": ends["tok"]}, "final_norm": ends["final_norm"],
              "layers": [draw_layer(model, i, seed, arm, device)
                         for i in range(model["num_layers"])]}
    if "head" in ends:
        layout["head"] = {"w": ends["head"]}
    return layout
