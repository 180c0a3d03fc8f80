"""The mesh and its all-reduce, in one process.

The reference's mesh is single-controller: one process calls
``refine_leastsq(f, reader, mesh=mesh)``, GSPMD partitions the solve over
the mesh's devices and inserts the all-reduce of slots tied across lanes,
and ``shard_map`` runs a kernel per device.  The port keeps that contract
with one controller over a list of torch devices:

- ``Mesh``: the devices, one per shard, in shard order.  A device may
  appear more than once (``["cuda:0"] * 4``, ``["cpu"] * 4``): several
  shards on one card or on the host, the counterpart of the reference's
  virtual CPU devices.  Nothing moves a shard to another device.
- ``split_lanes`` / ``join_lanes``: the lane axis cut into one block a
  shard, each on its shard's device, and joined back in lane order.  The
  callers run the shards one after another from this process; CUDA
  launches return at once, so shards on several cards overlap up to each
  shard's host syncs (the refit loop reads one a round); scaling across
  cards is not measured.
- ``all_reduce(parts, op)``: the per-shard tensors summed (or maxed) in
  shard order on the first shard's device, the result sent back to each
  shard's device.  The order is fixed, so the same mesh gives bit-equal
  results from run to run; on a mesh of one shard it returns its input.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Mesh", "all_reduce", "split_lanes", "join_lanes"]


def _as_device(d) -> torch.device:
    """``d`` as a torch.device; a CUDA device without an index is card 0."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", 0)
    return d


class Mesh:
    """A 1D mesh of torch devices: shard ``s`` lives on ``devices[s]``.

    ``devices`` (numpy object array, as the reference's ``Mesh.devices``),
    ``axis_names``, ``shape`` ({axis: shards}) and ``size`` are what the
    callers read; ``distinct`` lists the devices the mesh spans, in order
    of first appearance."""

    def __init__(self, devices, axis_names=("data",)):
        devs = [_as_device(d) for d in devices]
        if not devs:
            raise ValueError("a Mesh needs at least one device")
        self.devices = np.empty(len(devs), dtype=object)
        self.devices[:] = devs
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != 1:
            raise ValueError("the port's Mesh has one axis")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.size}

    @property
    def distinct(self) -> list:
        out = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out


def all_reduce(parts, op="sum"):
    """Sum (``op='sum'``) or maximum (``op='max'``) of the per-shard
    tensors ``parts``, taken in shard order on ``parts[0]``'s device, and
    returned as one copy on each part's device (the same tensor where the
    device is the same).  A list of one is returned as it is."""
    acc = parts[0]
    for p in parts[1:]:
        p = p.to(acc.device)
        acc = acc + p if op == "sum" else torch.maximum(acc, p)
    copies = {}
    out = []
    for p in parts:
        if p.device not in copies:
            copies[p.device] = acc.to(p.device)
        out.append(copies[p.device])
    return out


def split_lanes(mesh, tensors, shared=()):
    """Per-shard argument tuples: every tensor of ``tensors`` cut along its
    first (lane) axis into ``mesh.size`` equal contiguous blocks, block
    ``s`` on ``mesh.devices[s]``; a tensor of ``shared`` (the frames) is
    placed whole, once per distinct device, and comes first.  ``None``
    stays None."""
    S = mesh.size
    on_device = {}
    out = []
    for s, dev in enumerate(mesh.devices):
        if dev not in on_device:
            on_device[dev] = tuple(
                None if t is None else t.to(dev) for t in shared)
        lane = []
        for t in tensors:
            if t is None:
                lane.append(None)
                continue
            B = t.shape[0]
            if B % S:
                raise ValueError(f"{B} lanes do not split over {S} shards")
            per = B // S
            lane.append(t[s * per:(s + 1) * per].to(dev))
        out.append(on_device[dev] + tuple(lane))
    return out


def join_lanes(parts, device):
    """Per-shard tensors joined along the lane axis on ``device``."""
    return torch.cat([p.to(device) for p in parts], dim=0)
