"""Sharded loop-candidate matching over the ranks of a process group.

PyTorch counterpart of slam_toolbox_tpu/dist/match_dist.py. Loop-closure
candidate verification is embarrassingly parallel across candidate
chains: each chain has its own raster and the same query scan.
`match_chains_sharded` gives each rank a contiguous slice of the chains,
which it rasterizes and scores on its own device through its Matcher
(K2 scatter -> K3 smear -> K1 window score, the coarse pass only), and
joins the packed result rows with one all_gather, so N candidates cost
the time of ceil(N / ranks) — the multi-card analog of the reference's
one-at-a-time TryCloseLoop sweep (Mapper.cpp:1500-1561).

Integration: PoseGraph.try_close_loop routes its classic coarse fan-out
here when there is more than one chain and more than one rank. On one
rank the rows are those of `Matcher.match_scans_batch(scan, chains,
penalize=False, refine=False)` bit for bit (the same dispatches).
"""
from __future__ import annotations

import torch

from slam_toolbox_tpu_torch.dist import multihost
from slam_toolbox_tpu_torch.kernels.match import Matcher


def default_mesh(device=None):
    return multihost.global_mesh(device)


def match_chains_sharded(matcher: Matcher, scan, base_sets, mesh=None):
    """Coarse-match `scan` against every chain in `base_sets`, the chains
    split over the mesh's ranks. Drop-in for
    `matcher.match_scans_batch(scan, base_sets, penalize=False,
    refine=False)`; every rank calls it with the same arguments and gets
    every chain's result. The chain count is padded to a multiple of the
    rank count; a padding slot launches nothing and its zero row is
    dropped."""
    if not base_sets:
        return []
    if mesh is None:
        mesh = default_mesh(matcher.device)
    S = len(base_sets)
    per = -(-S // mesh.size)
    mine = base_sets[mesh.rank * per:(mesh.rank + 1) * per]
    rows = torch.zeros((per, 13), dtype=torch.float32, device=mesh.device)
    packs = matcher.dispatch_scans_batch(scan, mine, penalize=False,
                                         refine=False)
    if packs:
        rows[:len(packs)] = torch.stack(packs).to(mesh.device)
    rows = mesh.all_gather(rows)
    return Matcher.results_from_packed(rows[:S].cpu().numpy())
