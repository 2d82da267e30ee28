"""Hierarchy persistence: save a built hierarchy, reload it without setup.

The reference rebuilds its hierarchy on every run; mfmg_tpu added a ``.npz``
of the flattened JAX pytree with a pickled treedef (mfmg_tpu/utils/
serialize.py).  The port keeps its own format, which it does not share with
mfmg_tpu (neither reads the other's files): one file written by
``torch.save`` holding only plain data, readable with ``torch.load(path,
weights_only=True)`` and numpy, bfloat16 buffers included:

    {"format": FORMAT,
     "config": the Config as nested dicts,
     "dtype": "float32" | ..., "setup_route": ..., "n_dofs": int,
     "A_shapes": [[rows, cols], ...], "A_nnzs": [int, ...],
     "levels": [module, ...]}

where a module is {"class": "mfmg_torch.<module>.<Class>", "attrs": {name:
int | float | bool | str | None | tuple | list | dict}, "tensors": {name:
CPU tensor or None}, "modules": {name: module or None or {"list":
[module, ...]}}}, the ``nn.Module`` tree of each LevelData (operator,
smoother, transfer, coarse solver, nested levels).

What is derived is not stored and is rebuilt by ``load``: the fused coarse
tail (its operands are copies of level data, its plan a function of their
shapes) and the K2-backed fused smoother on the card (the level-0 Chebyshev
smoother is stored unfused); the kernels' launch plans are computed at
launch from the shapes, as after a fresh setup.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch
from torch import nn

FORMAT = "mfmg_torch.hierarchy/1"


def _encode(m):
    if m is None:
        return None
    if isinstance(m, nn.ModuleList):
        return {"list": [_encode(x) for x in m]}
    cls = type(m)
    if not cls.__module__.startswith("mfmg_torch."):
        raise TypeError(f"cannot store a {cls.__module__}.{cls.__qualname__}")
    attrs = {k: v for k, v in vars(m).items()
             if not k.startswith("_") and k != "training"}
    for k, v in attrs.items():
        if isinstance(v, (torch.Tensor, nn.Module)):
            raise TypeError(f"{cls.__qualname__}.{k} is an unregistered tensor "
                            f"or module")
    return {"class": f"{cls.__module__}.{cls.__qualname__}", "attrs": attrs,
            "tensors": {k: None if t is None else t.detach().cpu()
                        for k, t in m._buffers.items()},
            "modules": {k: _encode(sub) for k, sub in m._modules.items()}}


def _decode(node):
    if node is None:
        return None
    if "list" in node:
        return nn.ModuleList([_decode(x) for x in node["list"]])
    mod_name, _, cls_name = node["class"].rpartition(".")
    if not mod_name.startswith("mfmg_torch."):
        raise ValueError(f"not a mfmg_torch class: {node['class']!r}")
    cls = getattr(importlib.import_module(mod_name), cls_name)
    m = cls.__new__(cls)
    nn.Module.__init__(m)
    for k, v in node["attrs"].items():
        setattr(m, k, v)
    for k, t in node["tensors"].items():
        m.register_buffer(k, t)
    for k, sub in node["modules"].items():
        m.add_module(k, _decode(sub))
    return m


def _stored_level(level, unfused_smoother):
    """A level as stored: no fused tail, the unfused level-0 smoother."""
    from mfmg_torch.amge.hierarchy import LevelData
    return LevelData(level.op, smoother=unfused_smoother or level.smoother,
                     transfer=level.transfer, coarse=level.coarse)


def save_hierarchy(hier, path: str) -> None:
    """Write ``hier`` (a built mfmg_torch Hierarchy) to ``path``."""
    levels = [_stored_level(lv, hier._unfused_smoother0 if i == 0 else None)
              for i, lv in enumerate(hier.levels)]
    torch.save({
        "format": FORMAT,
        "config": dataclasses.asdict(hier.config),
        "dtype": str(hier.dtype).removeprefix("torch."),
        "setup_route": hier.setup_route,
        "n_dofs": int(hier._A_shapes[0][0]),
        "A_shapes": [list(s) for s in hier._A_shapes],
        "A_nnzs": [int(n) for n in hier._A_nnzs],
        "levels": [_encode(lv) for lv in levels],
    }, path)


def config_from_dict(d: dict):
    """The Config of ``dataclasses.asdict(config)``."""
    from mfmg_torch.config import (AgglomerationConfig, CoarseConfig, Config,
                                   EigensolverConfig, SmootherConfig)
    sub = dict(eigensolver=EigensolverConfig, smoother=SmootherConfig,
               coarse=CoarseConfig, agglomeration=AgglomerationConfig)
    return Config(**{k: sub[k](**v) if k in sub else v for k, v in d.items()})


def load_hierarchy(path: str, problem=None, device="cuda"):
    """A ready-to-apply Hierarchy from :func:`save_hierarchy`'s file, every
    level placed on ``device`` (the card unless the caller asks for the
    CPU) and, on the card, the fused smoother and tail rebuilt as the
    constructor does.  ``problem`` (the one it was built for) serves the
    rate and CG helpers, and the outer CG's full-precision operator."""
    from mfmg_torch.amge.hierarchy import Hierarchy, _torch_dtype
    from mfmg_torch.utils.device import checked_device

    d = torch.load(path, map_location="cpu", weights_only=True)
    if d.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} file")
    if problem is not None and problem.n_dofs != d["n_dofs"]:
        raise ValueError(f"{path} holds a hierarchy of {d['n_dofs']} dofs, "
                         f"the problem has {problem.n_dofs}")
    hier = Hierarchy.__new__(Hierarchy)
    hier.config = config_from_dict(d["config"])
    hier.problem = problem
    hier.device = checked_device(device)
    hier.dtype = _torch_dtype(d["dtype"])
    hier.setup_seconds = {}
    hier.setup_route = d["setup_route"]
    hier.per_cell_levels = []
    hier.eigensolver_stats = {}
    hier._exact_op_cache = None
    hier._device_A = None
    hier._level0_blocks = None
    hier._unfused_smoother0 = None
    hier._A_shapes = [tuple(s) for s in d["A_shapes"]]
    hier._A_nnzs = list(d["A_nnzs"])
    hier.levels = nn.ModuleList([_decode(n) for n in d["levels"]])
    hier.levels.to(hier.device)
    hier._finalize_cuda_kernels()
    return hier
