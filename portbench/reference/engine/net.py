# The benchmark's plain reference: a frozen copy of madsim_tpu_torch/engine/net.py, run on the CPU.
# A change to the program's semantics reaches it only through a change to the benchmark.
"""Link-state network model as batched tensors (counterpart of
``madsim_tpu/engine/net.py``).

Per seed: ``clog bool[N, N]`` (row = src, col = dst), the Q0.32 loss
probability, the latency range, and the buggified latency-spike
probability and range. ``route`` is the reference's ``test_link``: a
message is dropped when its directed link is clogged or the loss draw
fires; otherwise it arrives after a drawn latency. The spike coin reuses
the loss draw remixed by a multiplicative hash, as the reference does.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .ops import expand, get1, get2
from .rng import M32, bounded, coin, mul32


class LinkState(NamedTuple):
    clog: torch.Tensor  # bool[S, N, N]
    loss_q32: torch.Tensor  # uint32[S]
    lat_lo_ns: torch.Tensor  # int64[S]
    lat_hi_ns: torch.Tensor  # int64[S]
    buggify_q32: torch.Tensor  # uint32[S] (0 = spikes off)
    spike_lo_ns: torch.Tensor  # int64[S]
    spike_hi_ns: torch.Tensor  # int64[S]


def make(
    num_seeds: int,
    num_nodes: int,
    loss_q32: int = 0,
    lat_lo_ns: int = 1_000_000,
    lat_hi_ns: int = 10_000_000,
    buggify_q32: int = 0,
    spike_lo_ns: int = 1_000_000_000,
    spike_hi_ns: int = 5_000_000_000,
    device=None,
) -> LinkState:
    def full(v, dtype):
        return torch.full((num_seeds,), v, dtype=torch.int64, device=device).to(dtype)

    return LinkState(
        clog=torch.zeros((num_seeds, num_nodes, num_nodes), dtype=torch.bool, device=device),
        loss_q32=full(loss_q32, torch.uint32),
        lat_lo_ns=full(lat_lo_ns, torch.int64),
        lat_hi_ns=full(lat_hi_ns, torch.int64),
        buggify_q32=full(buggify_q32, torch.uint32),
        spike_lo_ns=full(spike_lo_ns, torch.int64),
        spike_hi_ns=full(spike_hi_ns, torch.int64),
    )


def _latency(links: LinkState, u_loss, u_lat):
    """Latency draw with buggified spikes (spike coin = remixed loss draw)."""
    u_spike = (mul32(u_loss.to(torch.int64), 2654435761) + 0x9E3779B9) & M32
    spike = coin(u_spike, expand(links.buggify_q32, u_loss.ndim))
    normal = bounded(
        u_lat, expand(links.lat_lo_ns, u_lat.ndim), expand(links.lat_hi_ns, u_lat.ndim) + 1
    )
    spiked = bounded(
        u_lat, expand(links.spike_lo_ns, u_lat.ndim), expand(links.spike_hi_ns, u_lat.ndim) + 1
    )
    return torch.where(spike, spiked, normal)


def route(links: LinkState, now_ns, src, dst, u_loss, u_lat) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-message link test: ``(deliver_time_ns [S], deliver [S])``."""
    clogged = get2(links.clog, src, dst)
    lost = coin(u_loss, links.loss_q32)
    return now_ns + _latency(links, u_loss, u_lat), ~(clogged | lost)


def route_from(links: LinkState, now_ns, src, u_loss, u_lat) -> Tuple[torch.Tensor, torch.Tensor]:
    """``route`` from ``src`` to every node at once (a broadcast):
    ``u_loss``/``u_lat`` are ``[S, N]``; returns ``[S, N]`` times and
    deliver flags."""
    clogged = get1(links.clog, src)
    lost = coin(u_loss, links.loss_q32[:, None])
    return now_ns[:, None] + _latency(links, u_loss, u_lat), ~(clogged | lost)
