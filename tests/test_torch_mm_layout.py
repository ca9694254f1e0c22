"""The launch geometry of K10's forward, weight gradient (db) and input
gradient (da), on the CPU: the wrapper's pure-Python functions that
``ops/mm.py`` hands to ``csrc/mixed_mm.cu`` (db's row ranges and ring
depth, the bulk-copy rule with its tail, the forward's narrow or wide
instantiation, da's ring depth, depth instantiation, stage rows and
row-tile ranges, the shared memory of each) at the shapes that the production chunk gives
K10 under ``EGONERF_MIXED_MM=1``: l1 150 -> 128, l2 128 -> 128, l3 128 ->
3, the basis of both charts 144 -> 54, the hoist's features 135 -> 128 and
its ray term 15 -> 128.  da of a product (K, N) is dout (M, N) @ b^T: depth
N, K output columns."""
import pytest

from egonerf_torch.ops import mm

SMS = 132  # the H100's SMs
SMEM_SM = 228 * 1024  # shared memory of one SM
SMEM_RESERVED = 1024  # the system's share a block
# (K, N) of each recorded product
SHAPES = {"l1": (150, 128), "l2": (128, 128), "l3": (128, 3), "basis": (144, 54),
          "hoist": (135, 128), "ray term": (15, 128)}
WIDTHS = (150, 144, 135, 128, 15)


def _last_stage(m, per_block):
    """Rows of the last stage of the last row range."""
    last = m - (-(-m // per_block) - 1) * per_block
    return (last - 1) % mm.DB_ROWS + 1


@pytest.mark.parametrize("m", [1 << 20, 1_048_575, 1_048_577, 4096, 17, 1])
def test_db_row_ranges(m):
    """Contiguous ranges of a multiple of 32 rows (each stage then starts on
    a 16-byte boundary for any K), about one a SM, covering every row."""
    per_block, splits = mm.db_row_ranges(m, SMS)
    assert per_block % mm.DB_ROWS == 0 and per_block >= mm.DB_ROWS
    assert (splits - 1) * per_block < m <= splits * per_block
    assert splits <= SMS
    if m >= 1 << 20:
        assert (per_block, splits) == (7968, 132)


def test_db_row_ranges_share_the_card_between_groups():
    """Two groups of outputs (K > 160) take about half an SM each; N <= 16
    takes the narrow warps, 256 x 16 outputs a group."""
    assert mm.db_groups(300, 128) == 2 and mm.db_groups(150, 300) == 3
    assert mm.db_layout(3) == "narrow" and mm.db_layout(17) == "wide"
    assert mm.db_groups(128, 3) == 1 and mm.db_groups(300, 3) == 2
    per_block, splits = mm.db_row_ranges(1 << 20, SMS, 2)
    assert 2 * splits <= SMS + 1 and per_block % mm.DB_ROWS == 0


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_one_group_holds_each_recorded_product(name):
    """Every recorded db fits one block's outputs (160 x 128, or 256 x 16
    for l3): each row of a and dout is read from device memory once."""
    assert mm.db_groups(*SHAPES[name]) == 1


@pytest.mark.parametrize("k", WIDTHS)
@pytest.mark.parametrize("m", [1_048_575, 1_048_577])
def test_bulk_copy_tail(m, k):
    """The last stage of the last range at M off the production chunk: its
    rows of K floats go as one bulk copy of a multiple of 16 bytes and the
    last (rows K) mod 4 floats by plain loads; a full stage is one copy."""
    per_block, _ = mm.db_row_ranges(m, SMS)
    rows = _last_stage(m, per_block)
    assert rows == {1_048_575: 31, 1_048_577: 1}[m]
    bulk, plain = mm.bulk_copy(rows, k)
    assert bulk % 16 == 0 and 0 <= plain < 4 and bulk + 4 * plain == 4 * rows * k
    assert plain == rows * k % 4
    assert mm.bulk_copy(mm.DB_ROWS, k) == (4 * mm.DB_ROWS * k, 0)


@pytest.mark.parametrize("k", WIDTHS + (3, 54))
def test_bulk_copies_cover_every_row_once(k):
    """Walking the stages of every range at M = 1,048,575: each stage's copy
    starts on a 16-byte boundary and bulk + plain bytes are its rows."""
    m = 1_048_575
    per_block, splits = mm.db_row_ranges(m, SMS)
    covered = 0
    for s in range(splits):
        r_end = min(m, (s + 1) * per_block)
        for r0 in range(s * per_block, r_end, mm.DB_ROWS):
            rows = min(mm.DB_ROWS, r_end - r0)
            bulk, plain = mm.bulk_copy(rows, k)
            assert (4 * r0 * k) % 16 == 0
            covered += bulk // 4 + plain
    assert covered == m * k


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_db_shared_memory(name):
    """Four stages of the ring fit in a block's 227 KB at every recorded
    shape (l1: 4 x 35,584 bytes of float32 rows and two bf16 tiles of
    19,456)."""
    k, n = SHAPES[name]
    stages = mm.db_stages(k, n)
    assert stages == mm.DB_MAX_STAGES
    assert mm.db_smem_bytes(k, n, stages) <= 227 * 1024
    if name == "l1":
        assert mm.db_smem_bytes(k, n, stages) == 4 * 35_584 + 2 * 19_456


def test_db_stages_shrink_then_refuse():
    """Wide operands take fewer stages, never fewer than two."""
    assert mm.db_stages(300, 150) == 2
    with pytest.raises(ValueError, match="too large"):
        mm.db_stages(600, 600)


@pytest.mark.parametrize("n,want", [(3, "narrow4"), (4, "narrow4"), (5, "narrow16"),
                                    (16, "narrow16"), (17, "wide64"), (54, "wide64"),
                                    (64, "wide64"), (65, "wide128"), (128, "wide128"),
                                    (300, "wide128")])
def test_forward_layout(n, want):
    """The narrow instantiation (a thread a row and all its 4 or 16 columns)
    up to 16 columns, the wide one with 64 or 128 columns a block past
    that; l3 (N = 3) narrow, the basis (54) wide of 64, l1 (128) of 128."""
    assert mm.fwd_layout(128, n) == want


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_forward_shared_memory(name):
    """Each recorded forward's blocks fit an SM as the design needs: two
    of the 128-column instantiation, four of the 64-column one."""
    k, n = SHAPES[name]
    layout = mm.fwd_layout(k, n)
    assert layout == {"l3": "narrow4", "basis": "wide64"}.get(name, "wide128")
    smem = mm.fwd_smem_bytes(k, layout)
    blocks = {"wide128": 2, "wide64": 4}.get(layout, 1)
    assert smem <= 227 * 1024 and blocks * (smem + SMEM_RESERVED) <= SMEM_SM
    if name == "l1":  # b over 152 depths x 128 columns, a 32 x 132 chunk of a
        assert smem == 4 * (152 * 128 + 32 * 132)
    if name == "basis":  # b over 144 depths x 64 columns, a 32 x 68 chunk
        assert smem == 4 * (144 * 64 + 32 * 68)
    if name == "l3":  # b alone: a is read from device memory
        assert smem == 4 * 128 * 4


def test_forward_deep_products_take_64_columns_a_block():
    """Past a depth of 420 b's 128 columns no longer fit beside a's chunk:
    64 columns a block, more column blocks."""
    assert mm.fwd_layout(420, 128) == "wide128"
    assert mm.fwd_layout(424, 128) == "wide64"
    assert mm.fwd_smem_bytes(424, "wide64") <= 227 * 1024


# da of every recorded product holds 4 stages: the staging tiles hold the
# block's columns as they lie in da (l1: 64 x 150 floats) and b^T sits in
# registers
DA_ROWS = [1 << 20, 1_048_575, 1_048_577, 17, 1]


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_da_shared_memory_and_stages(name):
    """The most stages (up to DA_MAX_STAGES) whose block fits 227 KB (l1: 4
    stages of 64 x 136 floats and two staging tiles of 64 x 150 floats)."""
    k, n = SHAPES[name]
    stages = mm.da_stages(n, k)
    assert stages == mm.DA_MAX_STAGES
    assert mm.da_smem_bytes(n, k, stages) <= 227 * 1024
    if name == "l1":
        assert mm.da_smem_bytes(n, k, stages) == 4 * (4 * 64 * 136 + 2 * 64 * 150)


def test_da_takes_depths_up_to_160_and_refuses_deeper():
    """Every depth from 1 to 160 fits the ring's three stages at 160
    columns (and wider N: further column blocks of 160), with b^T's k16
    steps in one of the kernel's instantiations (1, 4, 8, 10); a deeper
    product is refused (b^T's fragments would not fit a warp's registers)."""
    for depth in range(1, mm.DA_MAX_DEPTH + 1):
        for n in (160, 480):
            stages = mm.da_stages(depth, n)
            assert stages in (3, mm.DA_MAX_STAGES)
            assert mm.da_smem_bytes(depth, n, stages) <= 227 * 1024
        ks = mm.da_ks(depth)
        assert 16 * ks >= depth and ks in (1, 4, 8, 10)
        assert all(16 * smaller < depth for smaller in (1, 4, 8, 10) if smaller < ks)
    assert mm.da_stages(160, 160) == 3
    assert [mm.da_ks(SHAPES[s][1]) for s in ("l1", "l3", "basis")] == [8, 1, 4]
    for depth in (0, 161, 300):
        with pytest.raises(ValueError, match="depths 1 to 160"):
            mm.da_stages(depth, 150)


@pytest.mark.parametrize("w", sorted({n for _, n in SHAPES.values()} | {4, 8, 24, 32, 160}))
def test_da_stage_rows_spread_a_half_warp_over_the_banks(w):
    """A padded stage row (depth a multiple of 4) keeps 16-byte pieces
    aligned and puts the rows g = 0..3 of a half-warp's float2 fragment
    access on four distinct groups of 8 banks; a depth off the multiple of
    4 keeps its rows as they lie (one contiguous range)."""
    ld = mm.da_lda(w)
    if w % 4:
        assert ld == w
    else:
        assert ld % 4 == 0 and ld >= w
        assert len({g * ld % 32 // 8 for g in range(4)}) == 4


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("m", DA_ROWS)
def test_da_row_and_output_ranges(m, name):
    """Walking da's row tiles: each tile's dout rows and its rows of da are
    each one range starting on a 16-byte boundary, copied in 16-byte pieces
    (dout by cp.async, da by the bulk copy), the last (rows x width) mod 4
    floats of a tail tile plainly; every row once."""
    k, n = SHAPES[name]
    depth, cols = n, k
    tiles = -(-m // mm.DA_TILE)
    moved = {depth: 0, cols: 0} if depth != cols else {depth: 0}
    for tile in range(tiles):
        rows = min(mm.DA_TILE, m - tile * mm.DA_TILE)
        for width in moved:
            off, bulk, plain = mm.da_tile_range(m, width, tile)
            assert off == 4 * tile * mm.DA_TILE * width and off % 16 == 0
            assert bulk % 16 == 0 and 0 <= plain < 4 and bulk + 4 * plain == 4 * rows * width
            assert plain == rows * width % 4
            moved[width] += bulk // 4 + plain
    assert all(total == m * width for width, total in moved.items())
    if depth % 4 == 0:  # rows copied one by one: each starts on 16 bytes
        assert 4 * depth % 16 == 0
