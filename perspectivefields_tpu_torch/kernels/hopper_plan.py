"""Host-side launch planning shared by the bf16 kernels on csrc/hopper_gemm.cuh.

Each kernel module keeps its own shared-memory layout (``smem_bytes``) and
cycle model; what they share lives here: the card's limits, the ring's
depth, the multicast cluster's size and the launch plan read with the
card's own count of the clusters it runs at once.
"""

from __future__ import annotations

import functools

import torch

SMEM_LIMIT = 232448  # bytes of shared memory a block may use on the H100
STAGE_BYTES = 16384  # one ring stage: a 16 KB weight tile (hopper_gemm.cuh: kStageBytes)
MAX_STAGES = 6
CLUSTERS = (8, 4, 2, 1)  # cluster sizes tried, largest first (8: the portable limit)
# the planners' tensor-core FLOP a cycle on one SM (about half the H100's
# dense bf16 peak)
TC_FLOP_PER_CYCLE = 2000


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def ring_stages(smem, least: int = 2) -> int:
    """As many ring stages as fit: the most ``s`` (``least`` to
    ``MAX_STAGES``) with ``smem(s)`` within the limit, ``least`` always."""
    return max(s for s in range(least, MAX_STAGES + 1) if s == least or smem(s) <= SMEM_LIMIT)


def fit_counts(fits: tuple, sms: int):
    """k -> how many clusters of k the card runs at once: from ``fits``'
    (k, count) pairs where given (``clusters_fit`` on the card), else sms // k."""
    return dict(fits).get if fits else (lambda k: sms // k)


def multicast_cluster(tiles: int, fit) -> int:
    """The largest cluster of ``CLUSTERS`` that multicasts the weights over
    that many neighbouring tiles and costs no extra waves: at least 2
    clusters' worth of tiles, runs on the card, and no more waves than
    single blocks."""

    def waves(k):
        return -(-(-(-tiles // k)) // max(1, fit(k)))

    return next(k for k in CLUSTERS if k == 1 or (tiles >= 2 * k and fit(k) and waves(k) <= waves(1)))


def launch_plan(plan, clusters_fit, device: torch.device) -> dict:
    """``plan(sms, fits)`` with the card's own count of the clusters it runs
    at once: ``clusters_fit(p, k)`` for the plan ``p`` made without it."""
    sms = sm_count(device)
    p = plan(sms, ())
    return plan(sms, tuple((k, clusters_fit(p, k)) for k in CLUSTERS))
