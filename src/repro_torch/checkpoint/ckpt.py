"""Checkpoints in the reference's format, file for file (port of
`repro.checkpoint.ckpt`).

Format: one .npy a leaf, named by its tree path (`.params/tables/0`,
`.opt/.step`, `.opt/.m/item_proj`, with "/" -> "__" in the file name), and
manifest.json with each leaf's file, logical shape and dtype. A step is
written under step_NNNNNNNN.tmp/ and renamed atomically to
step_NNNNNNNN/; `restore` picks the newest complete step. bfloat16 is
stored as its raw u16 bits with "bfloat16" in the manifest. Each package
restores the other's checkpoints: the port's tree paths are the
reference's (a NamedTuple field is ".name", a dict key its key, a list
item its index, and a module's parameters their `param_tree` paths).

Elastic checkpoints: on a process grid (`grid=` with the state's
`layout`, {leaf name: (spec, full shape)}, `train_step.Placement.leaves`)
a save writes the same files as an unsharded save of the full state, byte
for byte: rank 0 lays every leaf's .npy out at its full size, and each
rank writes its own block into it at its offset (a replicated block by
one rank), so no rank gathers a table. `restore(..., grid=, layout=)`
reads only this rank's block of each leaf, onto any grid; the plain
`restore` reads a sharded save onto one process.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim.adamw import _path_key, param_tree


def _children(tree) -> Optional[list]:
    """[(path component, child)] of a container, None for a leaf."""
    if isinstance(tree, nn.Module):
        return list(param_tree(tree).items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [("." + f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree, key=lambda k:
                                                  _path_key(str(k)))]
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{tree path: leaf} in the reference's flatten order."""
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for name, child in kids:
        out.update(_flatten(child, f"{prefix}/{name}" if prefix else name))
    return out


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A numpy copy of a leaf and its logical dtype; bfloat16 as u16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _save_host(path: str, leaves: Iterable[Tuple[str, Tuple[np.ndarray,
                                                             str]]], *,
               step: int, extra_meta: Optional[dict] = None) -> str:
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "time": time.time(),
                "leaves": {}, **(extra_meta or {})}
    for name, (arr, logical) in leaves:
        fn = _file(name)
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"][name] = {"file": fn, "shape": list(arr.shape),
                                    "dtype": logical}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)           # atomic publish
    return final


def save(path: str, tree: Any, *, step: int,
         extra_meta: Optional[dict] = None, grid=None,
         layout: Optional[Dict[str, Tuple[tuple, tuple]]] = None) -> str:
    """Synchronous save, one leaf at a time through the host. Returns the
    final step dir. With `grid` (and the state's `layout`): every rank of
    the grid calls it together with its blocks (module docstring)."""
    if grid is not None:
        return _save_sharded(path, tree, step=step, extra_meta=extra_meta,
                             grid=grid, layout=layout)
    leaves = ((n, _host(l)) for n, l in _flatten(tree).items())
    return _save_host(path, leaves, step=step, extra_meta=extra_meta)


def _npy_dtype(leaf: torch.Tensor) -> Tuple[np.dtype, str]:
    if leaf.dtype == torch.bfloat16:
        return np.dtype(np.uint16), "bfloat16"
    dt = torch.empty(0, dtype=leaf.dtype).numpy().dtype
    return dt, str(dt)


def _save_sharded(path: str, tree: Any, *, step: int,
                  extra_meta: Optional[dict], grid, layout) -> str:
    import torch.distributed as dist
    from repro_torch.distributed.sharding import block_slices, owner
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    leaves = _flatten(tree)
    if set(leaves) != set(layout):
        raise ValueError("the layout does not name the state's leaves")
    fmt = np.lib.format
    if grid.rank == 0:
        os.makedirs(tmp, exist_ok=True)
        for name, leaf in leaves.items():
            dt, _ = _npy_dtype(leaf)
            del_ = fmt.open_memmap(os.path.join(tmp, _file(name)),
                                   mode="w+", dtype=dt,
                                   shape=layout[name][1])
            del del_           # the header and the zero-filled data
    dist.barrier()
    for name, leaf in leaves.items():
        spec, shape = layout[name]
        if not owner(spec, grid) or not int(np.prod(shape)):
            continue
        arr, _ = _host(leaf)
        mm = fmt.open_memmap(os.path.join(tmp, _file(name)), mode="r+")
        mm[block_slices(shape, spec, grid)] = arr
        mm.flush()
        del mm
    dist.barrier()
    if grid.rank == 0:
        manifest = {"step": step, "time": time.time(),
                    "leaves": {}, **(extra_meta or {})}
        for name, leaf in leaves.items():
            manifest["leaves"][name] = {
                "file": _file(name), "shape": list(layout[name][1]),
                "dtype": _npy_dtype(leaf)[1]}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    dist.barrier()
    return final


def _file(name: str) -> str:
    return name.replace("/", "__") + ".npy"


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training (one in flight)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def save(self, path: str, tree: Any, *, step: int, **kw):
        self.wait()
        # copy to the host BEFORE returning: the next step updates the
        # parameters and the optimizer state in place
        host = [(n, _host(l)) for n, l in _flatten(tree).items()]

        def work():
            self.last_path = _save_host(path, host, step=step, **kw)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(path, d, "manifest.json"))]
    return max(steps) if steps else None


_SLAB_BYTES = 256 << 20   # host bytes a restore reads at a time


def _on(t: torch.Tensor, dev: torch.device) -> bool:
    return t.device.type == dev.type and (dev.index is None
                                          or t.device.index == dev.index)


def _load(d: str, info: dict, dev: torch.device, into: Any,
          stage: torch.Tensor, block: Optional[Tuple[slice, ...]] = None
          ) -> torch.Tensor:
    """One leaf's file, read into `into` when it is a tensor on `dev` with
    the stored shape and dtype, else into a new tensor on `dev`, a slab at
    a time through `stage` (a host byte buffer). `block`: the slices of
    the part to read (its rows a slab at a time from a memory map)."""
    shape = tuple(info["shape"])
    bf16 = info["dtype"] == "bfloat16"
    dtype = (torch.bfloat16 if bf16 else
             torch.from_numpy(np.empty(0, info["dtype"])).dtype)
    if block is not None:
        return _load_block(d, info, dev, into, stage, block, dtype)
    fits = (isinstance(into, torch.Tensor) and _on(into, dev)
            and tuple(into.shape) == shape and into.dtype == dtype
            and into.is_contiguous())
    dst = into if fits else torch.empty(shape, dtype=dtype, device=dev)
    if dst.numel() == 0:
        return dst
    flat = dst.detach().view(-1)
    if bf16:                        # the file holds the raw u16 bits
        flat = flat.view(torch.int16)
    fmt = np.lib.format
    with open(os.path.join(d, info["file"]), "rb") as f:
        major, _ = fmt.read_magic(f)
        _, fortran, _ = (fmt.read_array_header_1_0(f) if major == 1
                         else fmt.read_array_header_2_0(f))
        if fortran:
            raise ValueError(f"{info['file']}: Fortran order")
        per = len(stage) // flat.element_size()
        for i in range(0, flat.numel(), per):
            part = flat[i:i + per]
            buf = stage[:part.numel() * part.element_size()]
            if f.readinto(memoryview(buf.numpy())) != len(buf):
                raise ValueError(f"{info['file']}: truncated")
            part.copy_(buf.view(part.dtype))
    return dst


def _load_block(d: str, info: dict, dev: torch.device, into: Any,
                stage: torch.Tensor, block: Tuple[slice, ...],
                dtype: torch.dtype) -> torch.Tensor:
    mm = np.load(os.path.join(d, info["file"]), mmap_mode="r")
    part = mm[block] if mm.ndim else mm
    shape = tuple(part.shape)
    fits = (isinstance(into, torch.Tensor) and _on(into, dev)
            and tuple(into.shape) == shape and into.dtype == dtype
            and into.is_contiguous())
    dst = into if fits else torch.empty(shape, dtype=dtype, device=dev)
    if dst.numel() == 0:
        return dst
    flat = dst.detach().view(-1)
    if dtype == torch.bfloat16:
        flat = flat.view(torch.int16)
    if part.ndim == 0:
        flat.copy_(torch.from_numpy(np.array(part).reshape(1)).view(
            flat.dtype))
        return dst
    row = int(np.prod(shape[1:])) if len(shape) > 1 else 1
    per = max(1, len(stage) // (row * flat.element_size()))
    for i in range(0, shape[0], per):
        rows = part[i:i + per]
        n = rows.size * flat.element_size()
        np.copyto(stage[:n].numpy().view(rows.dtype).reshape(rows.shape),
                  rows)
        flat[i * row:i * row + rows.size].copy_(
            stage[:n].view(flat.dtype))
    del mm
    return dst


def _rebuild(like, loaded: Dict[str, torch.Tensor], prefix: str = ""):
    kids = _children(like)
    if kids is None:
        return loaded[prefix]
    if isinstance(like, nn.Module):
        for name, p in list(like.named_parameters()):
            path = name.replace(".", "/")
            t = loaded[f"{prefix}/{path}" if prefix else path]
            if t is not p:            # a new tensor: replace the parameter
                mod, _, attr = name.rpartition(".")
                setattr(like.get_submodule(mod), attr,
                        nn.Parameter(t, requires_grad=p.requires_grad))
        return like
    vals = {name: _rebuild(child, loaded,
                           f"{prefix}/{name}" if prefix else name)
            for name, child in kids}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(vals["." + f] for f in like._fields))
    if isinstance(like, dict):
        return {k: vals[str(k)] for k in like}
    return type(like)(vals[str(i)] for i in range(len(like)))


def restore(path: str, like: Any, *, step: Optional[int] = None,
            device: DeviceLike = None, grid=None,
            layout: Optional[Dict[str, Tuple[tuple, tuple]]] = None) -> Any:
    """Restore into the structure of `like` on `device` (default: the
    card). A tensor of `like` on `device` with the stored shape and dtype
    (a module's parameters among them) is overwritten in place, through
    one 256 MiB host slab, so a restore into a live state holds no second
    copy of it on the card or the host; any other leaf (one on the meta
    device: a skeleton) is made anew on `device`.

    With `grid` and `layout` (`train_step.Placement.leaves`), `like` holds
    this rank's blocks and each leaf's block is read from its file, and
    nothing else of it: a checkpoint saved on any grid, or by one
    process, restores onto this one."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    stage = torch.empty(_SLAB_BYTES, dtype=torch.uint8,
                        pin_memory=dev.type == "cuda")
    if grid is None:
        loaded = {n: _load(d, manifest["leaves"][n], dev, leaf, stage)
                  for n, leaf in _flatten(like).items()}
    else:
        from repro_torch.distributed.sharding import block_slices
        loaded = {}
        for n, leaf in _flatten(like).items():
            info = manifest["leaves"][n]
            spec, shape = layout[n]
            if tuple(info["shape"]) != tuple(shape):
                raise ValueError(f"{n}: stored {info['shape']}, the state's "
                                 f"is {shape}")
            loaded[n] = _load(d, info, dev, leaf, stage,
                              block_slices(shape, spec, grid))
    return _rebuild(like, loaded)
