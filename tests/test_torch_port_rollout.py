"""The rollout kernels' route (``cuda_rollout.rollout_route``), a pure
function of the shapes and the card's limits, at an H100's limits.

No JAX and no card: the route is decided before any launch, so it is
pinned here on the CPU.  The kernels on each route are held against their
plain versions on the card by
``test_torch_port_device.py::test_kernels_match_plain_on_card`` and by
``chip_smoke.py``.
"""

import pytest

from vae_connexe_torch.ops import cuda_rollout

# H100 SXM: opt-in shared memory of a block, shared memory of an SM, SMs,
# threads of an SM; clusters of 8 blocks portably, 16 non-portably.
H100 = (232448, 233472, 132, 2048, 8, 16)


@pytest.mark.parametrize("kind,heads,batch,d,hidden,want", [
    # The serving width (p=20, H=64): 3 heads a block on 7 blocks
    # (3,3,3,3,3,3,2), 8 rows a tile at B=3072 (224,416 bytes) with B1's
    # split of 2 (384 gate lanes); at B=1 4 rows, the k split over 4 lanes.
    ("crvae", 20, 3072, 20, 64, ("resident", 7, 3, 8, 2)),
    ("crvae", 20, 1, 20, 64, ("resident", 7, 3, 4, 4)),
    # lorenz96_crvae's width (p=10): 2 heads a block on 5 blocks.
    ("crvae", 10, 3072, 10, 64, ("resident", 5, 2, 16, 2)),
    # Fewer heads than a portable cluster: one head a block.
    ("crvae", 4, 37, 4, 8, ("resident", 4, 1, 4, 4)),
    ("crvae", 6, 37, 6, 16, ("resident", 6, 1, 4, 4)),
    # Hidden 128 (lorenz96_scaled, lorenz96_xl): one head's weights alone
    # are over a block's shared memory.  The streamed body: one block a
    # (tile, head), the widest tile (32 rows) whenever heads x tiles still
    # give all 132 SMs a block; at B=37 the 40 heads need tiles of 8 rows
    # (200 blocks) for that; at B=1 no tile does, and the narrowest wastes
    # the fewest rows.
    ("crvae", 40, 3072, 40, 128, ("streamed", 1, 1, 32, 0)),
    ("crvae", 40, 37, 40, 128, ("streamed", 1, 1, 8, 0)),
    ("crvae", 40, 1, 40, 128, ("streamed", 1, 1, 4, 0)),
    ("crvae", 128, 3072, 128, 128, ("streamed", 1, 1, 32, 0)),
    ("crvae", 128, 37, 128, 128, ("streamed", 1, 1, 32, 0)),
    # 128 heads at H=256: one row of every head's state overflowed the
    # first port's block; one head a block has a plan.
    ("crvae", 128, 8, 128, 256, ("streamed", 1, 1, 4, 0)),
    # The ErrorVAE: B1's cost model picks 24 rows (128 blocks) at B=3072;
    # at B=37 it ties 4 rows with 8, and the narrower tile is taken.
    ("errvae", 1, 3072, 20, 64, ("resident", 1, 1, 24, 2)),
    ("errvae", 1, 37, 20, 64, ("resident", 1, 1, 4, 4)),
    ("errvae", 1, 1, 20, 64, ("resident", 1, 1, 4, 4)),
    # K2 at hidden 128 in float32: one head, so B=3072 needs 16-row tiles
    # (192 blocks) and B=512 none gives every SM a block.
    ("errvae", 1, 3072, 40, 128, ("streamed", 1, 1, 16, 0)),
    ("errvae", 1, 512, 40, 128, ("streamed", 1, 1, 4, 0)),
])
def test_rollout_route(kind, heads, batch, d, hidden, want):
    plan = cuda_rollout.rollout_route(kind, heads, batch, d, hidden, H100)
    assert (plan.route, plan.cluster, plan.heads_per_block, plan.bt,
            plan.split) == want
    assert plan.smem <= H100[0]
    if plan.route == "resident":
        outs = 1 if kind == "crvae" else d
        assert plan.smem == cuda_rollout.resident_smem_bytes(
            plan.heads_per_block, plan.bt, d, hidden, outs, kind == "crvae")
        assert cuda_rollout.gate_threads(plan.heads_per_block, plan.bt,
                                         hidden, plan.split) <= plan.threads
        assert plan.cluster * plan.heads_per_block >= heads
        assert (plan.cluster - 1) * plan.heads_per_block < heads
        assert plan.cluster <= H100[4]
    else:
        outs = 1 if kind == "crvae" else d
        assert plan.smem == cuda_rollout.stream_smem_bytes(plan.bt, d, hidden,
                                                           outs)
        assert plan.threads == cuda_rollout.stream_threads(plan.bt, hidden)
        assert plan.threads <= cuda_rollout.stream_max_threads(plan.bt)
        assert plan.blocks == heads * -(-batch // plan.bt)
        assert plan.scratch == cuda_rollout.stream_scratch_bytes(
            plan.bt, heads, batch, d, hidden)


def test_rollout_route_raises_where_neither_route_fits():
    """Hidden 1024: the streamed body's ring of 8-row weight chunks alone
    is over a block at its smallest tile; the message names the bytes."""
    need = cuda_rollout.stream_smem_bytes(4, 128, 1024, 1)
    assert need > H100[0]
    with pytest.raises(ValueError, match=f"neither route.* {need} bytes"):
        cuda_rollout.rollout_route("crvae", 128, 8, 128, 1024, H100)


def test_rollout_route_takes_a_larger_cluster_only_when_no_portable_one_fits():
    """With 170,000 bytes a block, the 3 heads a block that a portable
    cluster needs at the serving width do not fit (209,664 bytes of
    weights), 2 do: the 20 heads go to a non-portable cluster of 10."""
    small = (170000,) + H100[1:]
    plan = cuda_rollout.rollout_route("crvae", 20, 3072, 20, 64, small)
    assert (plan.route, plan.cluster, plan.heads_per_block) == ("resident",
                                                                10, 2)
    assert plan.smem <= small[0]
