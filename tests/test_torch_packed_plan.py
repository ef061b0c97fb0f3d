"""The grid plans of the partial kernel that B2 and B3 share
(`plan_packed_scan`) and of B6's (`plan_pipelined_scan`): pure integer
arithmetic, so they are checked here on the CPU. Whatever the batch, bucket count, segment count, row width and SM
count, the blocks must cover every (query, lane, segment) exactly once, and
no part may cross a 256-segment super-tile (the hierarchical fold's merge
assumes it). The plan changes the grid, never the result."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from diskrag_tpu_torch.ops import flat_scan as tfs


def _check_cover(plan, b, nb, n_seg, row_bytes, bq=64):
    spp = plan.segs_per_part
    assert spp & (spp - 1) == 0 and 256 % spp == 0  # a power of two that divides 256
    parts = [(z * spp, min(n_seg, (z + 1) * spp)) for z in range(plan.n_parts)]
    # contiguous, in segment order, non-empty (one empty part for no segments)
    assert parts[0][0] == 0 and parts[-1][1] == n_seg
    assert all(lo < hi for lo, hi in parts) or n_seg == 0
    assert all(a[1] == b_[0] for a, b_ in zip(parts, parts[1:]))
    # no part crosses a super-tile of 256 segments
    assert all(lo // 256 == (hi - 1) // 256 for lo, hi in parts if hi > lo)
    qcount = np.zeros(b, dtype=np.int64)
    for x in range(plan.q_tiles):
        qcount[x * bq: min(b, (x + 1) * bq)] += 1
    lcount = np.zeros(nb, dtype=np.int64)
    for y in range(plan.lane_tiles):
        lcount[y * 64: min(nb, (y + 1) * 64)] += 1
    scount = np.zeros(n_seg, dtype=np.int64)
    for lo, hi in parts:
        scount[lo:hi] += 1
    assert (qcount == 1).all() and (lcount == 1).all() and (scount == 1).all()
    # no block without queries or lanes: the last query tile holds some
    assert plan.q_tiles * bq - b < bq and plan.lane_tiles * 64 == nb
    assert plan.n_seg == n_seg


@settings(max_examples=300, deadline=None, database=None)
@given(b=st.integers(1, 5000), nb_log=st.integers(7, 15), n_seg=st.integers(0, 4000),
       row_bytes=st.sampled_from(range(16, 193, 16)), sms=st.integers(1, 264))
def test_plan_packed_scan_covers_every_query_lane_segment_once(b, nb_log, n_seg, row_bytes, sms):
    nb = 1 << nb_log
    _check_cover(tfs.plan_packed_scan(b, nb, n_seg, row_bytes, sms), b, nb, n_seg, row_bytes)


@pytest.mark.parametrize(
    "b,nb,n_seg,row_bytes,want",
    [
        # flat-1M-packed: B3 at NB 512 over 1,003,520 rows, two parts a super-tile
        (1000, 512, 1960, 128, (16, 8, 128, 16)),
        # flat-200k-packed: B2 at NB 1024 over 200,704 rows, four parts
        (1000, 1024, 196, 128, (16, 16, 64, 4)),
        # a ragged super-tile: 70,016 rows at NB 128 (547 segments)
        (37, 128, 547, 48, (1, 2, 8, 69)),
        (4096, 128, 547, 192, (64, 2, 64, 9)),
        (65, 256, 3, 16, (2, 4, 1, 3)),
        (1, 128, 1, 144, (1, 2, 1, 1)),
    ],
)
def test_plan_packed_scan_at_known_shapes(b, nb, n_seg, row_bytes, want):
    plan = tfs.plan_packed_scan(b, nb, n_seg, row_bytes, 132)
    assert (plan.q_tiles, plan.lane_tiles, plan.segs_per_part, plan.n_parts) == want
    _check_cover(plan, b, nb, n_seg, row_bytes)


@pytest.mark.parametrize("args", [(10, 512, 8, 208, 132), (10, 512, 8, 40, 132),
                                  (10, 96, 8, 128, 132), (0, 512, 8, 128, 132)])
def test_plan_packed_scan_refuses_what_the_kernel_cannot_take(args):
    with pytest.raises(ValueError, match="packed scan"):
        tfs.plan_packed_scan(*args)


def test_plan_packed_scan_cuts_parts_only_where_the_card_starves():
    # many blocks already: one part per super-tile; few blocks over many
    # segments: parts until the blocks fill the SMs' slots about once
    many = tfs.plan_packed_scan(4096, 4096, 200, 128, 132)
    assert many.q_tiles * many.lane_tiles >= 132 * 3 and many.n_parts == 1
    few = tfs.plan_packed_scan(64, 128, 2048, 128, 132)
    assert few.q_tiles * few.lane_tiles == 2 and 132 <= few.n_parts * 2 <= 2 * 132 * 3


@settings(max_examples=300, deadline=None, database=None)
@given(b=st.integers(1, 5000), nb_log=st.integers(7, 15), n_seg=st.integers(0, 4000),
       row_bytes=st.sampled_from(range(16, 193, 16)), sms=st.integers(1, 264))
def test_plan_pipelined_scan_covers_every_query_lane_segment_once(b, nb_log, n_seg, row_bytes,
                                                                   sms):
    """B6's blocks hold 128 queries (two consumer warpgroups of 64)."""
    nb = 1 << nb_log
    _check_cover(tfs.plan_pipelined_scan(b, nb, n_seg, row_bytes, sms), b, nb, n_seg, row_bytes,
                 bq=128)


@pytest.mark.parametrize(
    "b,nb,n_seg,row_bytes,want",
    [
        # micro-1M / the 1M main shape: NB 512 over 1,003,520 rows
        (1000, 512, 1960, 128, (8, 8, 128, 16)),
        # NB 1024 at 1M
        (1000, 1024, 980, 128, (8, 16, 128, 8)),
        # 200k at NB 512 and NB 8192
        (1000, 512, 392, 128, (8, 8, 32, 13)),
        (1000, 8192, 25, 128, (8, 128, 32, 1)),
        (37, 128, 547, 48, (1, 2, 8, 69)),
        (65, 256, 3, 16, (1, 4, 1, 3)),
    ],
)
def test_plan_pipelined_scan_at_known_shapes(b, nb, n_seg, row_bytes, want):
    plan = tfs.plan_pipelined_scan(b, nb, n_seg, row_bytes, 132)
    assert (plan.q_tiles, plan.lane_tiles, plan.segs_per_part, plan.n_parts) == want
    _check_cover(plan, b, nb, n_seg, row_bytes, bq=128)


@pytest.mark.parametrize("args", [(10, 512, 8, 208, 132), (10, 512, 8, 40, 132),
                                  (10, 96, 8, 128, 132), (0, 512, 8, 128, 132)])
def test_plan_pipelined_scan_refuses_what_the_kernel_cannot_take(args):
    with pytest.raises(ValueError, match="pipelined scan"):
        tfs.plan_pipelined_scan(*args)
