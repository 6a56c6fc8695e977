"""The roll probes' two forms on the CPU: the plain versions against the
JAX probe bodies at every shift residue mod 4, numpy models of the wide
kernels' index maps against torch.roll, and the wrappers' choice of form
and refusals. tests/test_torch_cuda.py holds the kernels themselves
against the plain versions on a CUDA card.

The models restate, line for line, the index arithmetic of
csrc/lbm_probes.cu's wide kernels (lbm_roll_y_cluster: which CTA of a
cluster and which slot of its buffers each output vector goes to, and
the halo slot; lbm_roll_x_wide: which lane moves which vector of which
row), so that an index error shows here before a card runs the kernel. Rolls move
float32 values: every comparison is bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latticeboltzmann_tpu_torch.ops import probes

torch.set_num_threads(1)


def _block(shape, seed=0):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, shape).astype(np.float32)


# every residue mod 4, negative shifts, and the row's end
SHIFTS = [1, 2, 3, 4, 5, 96, -1, -2, -3, -6, "n-1", "n-2", "n"]


def _shift(spec, n):
    return {"n-1": n - 1, "n-2": n - 2, "n": n}.get(spec, spec)


@pytest.mark.parametrize("spec", SHIFTS)
@pytest.mark.parametrize("shape", [(32, 128), (32, 40), (32, 37)])
def test_roll_y_reference_is_the_jax_probe_body_at_every_residue(shape, spec):
    """scripts/anatomy.py:186-190 restated with jnp.roll: 6 and 7 chained
    rolls along y, and one torch.roll by the summed shift."""
    x = _block(shape)
    shift = _shift(spec, shape[1])
    for n_rolls in (6, 7):
        v = jnp.asarray(x)
        for _ in range(n_rolls):
            v = jnp.roll(v, shift, axis=1)
        got = probes.roll_y_reference(torch.as_tensor(x), shift, n_rolls)
        np.testing.assert_array_equal(got.numpy(), np.asarray(v))
        assert torch.equal(got, torch.roll(torch.as_tensor(x), n_rolls * shift % shape[1], 1))


@pytest.mark.parametrize("spec", SHIFTS)
@pytest.mark.parametrize("shape", [(40, 128), (40, 37), (7, 40)])
def test_roll_x_reference_is_the_jax_probe_body_at_every_residue(shape, spec):
    """scripts/anatomy.py:246-250 restated with jnp.roll: 8 and 9 chained
    rolls along x, and one torch.roll by the summed shift."""
    x = _block(shape, seed=1)
    shift = _shift(spec, shape[0])
    for n_rolls in (8, 9):
        v = jnp.asarray(x)
        for _ in range(n_rolls):
            v = jnp.roll(v, shift, axis=0)
        got = probes.roll_x_reference(torch.as_tensor(x), shift, n_rolls)
        np.testing.assert_array_equal(got.numpy(), np.asarray(v))
        assert torch.equal(got, torch.roll(torch.as_tensor(x), n_rolls * shift % shape[0], 0))


# ---- the wide y-roll's index map ----

def _compose(r, prev, cur):
    """compose<R>: the output vector of a shift of residue r from its two
    source vectors."""
    return np.concatenate([prev[4 - r:], cur[:4 - r]]) if r else cur.copy()


def _model_roll_y(row, shift, n_rolls, c):
    """lbm_roll_y_cluster on one row: c CTAs of seg vectors, each with two
    buffers of seg + 1 slots (slot 0 the halo); returns the row and, per
    roll, how often each (rank, slot) of the written buffers was
    written."""
    nyv = row.size // 4
    seg = nyv // c
    q, r = divmod(shift, 4)
    qc, ql = divmod(q, seg)
    vecs = row.reshape(nyv, 4)
    ring = np.full((c, 2, seg + 1, 4), np.nan, np.float32)
    for rank in range(c):
        first = rank * seg
        ring[rank, 0, 1:] = vecs[first:first + seg]
        ring[rank, 0, 0] = vecs[nyv - 1 if first == 0 else first - 1]
    cur, writes = 0, []
    for _ in range(n_rolls):
        hits = np.zeros((c, seg + 1), int)
        new = ring[:, cur ^ 1].copy()
        for rank in range(c):
            a = ring[rank, cur]
            for lv in range(seg):
                v = _compose(r, a[lv], a[1 + lv])
                dl, dr = lv + ql, rank + qc
                if dl >= seg:
                    dl, dr = dl - seg, dr + 1
                if dr >= c:
                    dr -= c
                new[dr, 1 + dl] = v
                hits[dr, 1 + dl] += 1
                if r and dl == seg - 1:
                    hr = 0 if dr + 1 == c else dr + 1
                    new[hr, 0] = v
                    hits[hr, 0] += 1
        ring[:, cur ^ 1] = new
        writes.append(hits)
        cur ^= 1
    return ring[:, cur, 1:].reshape(-1), writes


@pytest.mark.parametrize("ny", [16, 32, 48, 64, 80, 96, 112, 160, 208, 272])
def test_wide_roll_y_index_map_equals_torch_roll(ny):
    """A cluster of ROLL_Y_CLUSTER CTAs, every shift (each residue, across
    segments and the row's wrap), 0 to 3 rolls: the model's row equals
    torch.roll, and each roll writes every slot of every CTA's segment
    once and each halo once when the residue is not 0: the bytes each
    CTA's mbarrier expects per roll."""
    c = probes.ROLL_Y_CLUSTER
    row = _block((ny,), seed=ny)
    seg = ny // 4 // c
    assert seg * c * 4 == ny
    for shift in range(ny):
        for n_rolls in range(4):
            got, writes = _model_roll_y(row, shift, n_rolls, c)
            want = torch.roll(torch.as_tensor(row), n_rolls * shift % ny, 0).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"shift {shift}, {n_rolls} rolls")
            for hits in writes:
                assert (hits[:, 1:] == 1).all()
                assert (hits[:, 0] == (1 if shift % 4 else 0)).all(), (shift, hits[:, 0])


# ---- the wide x-roll's index map ----

def _model_roll_x(block, shift, n_rolls, vectors):
    """lbm_roll_x_wide on a block: one-warp CTAs of `vectors` vectors,
    lane t moving vector t % vectors of rows g, g + G, ... (g = t //
    vectors). Returns the block and, for each roll after the first, the
    (reader lane's CTA, writer's CTA) pairs of the slots a lane read:
    whose stores the roll's __syncwarp must order."""
    rows, ny = block.shape
    nyv = ny // 4
    groups = 32 // vectors
    out = np.full_like(block, np.nan)
    pairs = set()
    for cta in range(-(-nyv // vectors)):
        strips = np.full((2, rows, vectors, 4), np.nan, np.float32)
        writer = np.full((2, rows, vectors), -1)
        for t in range(32):
            vec, g = t % vectors, t // vectors
            v = cta * vectors + vec
            for i in range(g, rows, groups):
                if v < nyv:
                    strips[0, i, vec] = block[i, 4 * v: 4 * v + 4]
        cur = 0
        for k in range(n_rolls):
            for t in range(32):
                vec, g = t % vectors, t // vectors
                for i in range(g, rows, groups):
                    d = i + shift
                    if d >= rows:
                        d -= rows
                    if k:
                        pairs.add((cta, writer[cur, i, vec]))
                    strips[cur ^ 1, d, vec] = strips[cur, i, vec]
                    writer[cur ^ 1, d, vec] = cta
            cur ^= 1
        for vec in range(vectors):
            v = cta * vectors + vec
            if v < nyv:
                out[:, 4 * v: 4 * v + 4] = strips[cur, :, vec]
    return out, pairs


@pytest.mark.parametrize("rows, ny", [(40, 20), (40, 8), (40, 4), (7, 36), (3, 8), (17, 44),
                                      (64, 12), (33, 16)])
def test_wide_roll_x_index_map_equals_torch_roll(rows, ny):
    """Columns that leave the last CTA partly past NY's end (and rows
    fewer than a warp's row groups), every shift, 0 to 3 rolls: the model
    equals torch.roll, and every slot a roll reads was written by its own
    CTA's one warp (a __syncwarp orders it)."""
    x = _block((rows, ny), seed=rows * ny)
    for shift in range(rows):
        for n_rolls in range(4):
            got, pairs = _model_roll_x(x, shift, n_rolls, probes.ROLL_X_VECTORS)
            np.testing.assert_array_equal(
                got, torch.roll(torch.as_tensor(x), n_rolls * shift % rows, 0).numpy())
            assert all(a == b for a, b in pairs)


# ---- the wrappers: forms, refusals, the CPU path ----

def test_form_none_picks_the_faster_form_where_the_wide_one_applies():
    """DEFAULT_FORM: the narrow y-roll and the wide x-roll, the faster
    forms on an H100; form=None never picks a form that does not take the
    shape."""
    assert probes.DEFAULT_FORM == {"roll_y": "narrow", "roll_x": "wide"}
    assert probes._roll_form("roll_y", None, True, "") == "narrow"
    assert probes._roll_form("roll_y", None, False, "") == "narrow"
    assert probes._roll_form("roll_x", None, True, "") == "wide"
    assert probes._roll_form("roll_x", None, False, "") == "narrow"
    assert probes._roll_form("roll_y", "wide", True, "") == "wide"
    assert probes._cluster_takes(4000) and probes._cluster_takes(16)
    assert not any(probes._cluster_takes(ny) for ny in (40, 36, 37, 8))


@pytest.mark.parametrize("ny", [128, 40, 36, 37])
def test_every_form_on_the_cpu_gives_the_plain_result(ny):
    """On the CPU every form the shape takes returns the plain version's
    result and counts no launch."""
    x = torch.as_tensor(_block((32, ny), seed=5))
    xx = torch.as_tensor(_block((40, ny), seed=6))
    before = dict(probes.LAUNCHES), dict(probes.ROLL_FORM_LAUNCHES)
    y_kws = [{}, {"form": "narrow"}, {"mechanism": "shuffle"}]
    x_kws = [{}, {"form": "narrow"}, {"mechanism": "global"}]
    if ny % (4 * probes.ROLL_Y_CLUSTER) == 0:
        y_kws.append({"form": "wide"})
    if ny % 4 == 0:
        x_kws.append({"form": "wide"})
    for shift in (1, 2, 3, 4, -1):
        for kw in y_kws:
            assert torch.equal(probes.roll_y(x, shift, 6, **kw), torch.roll(x, 6 * shift % ny, 1))
        for kw in x_kws:
            assert torch.equal(probes.roll_x(xx, shift, 8, **kw), torch.roll(xx, 8 * shift % 40, 0))
    assert (dict(probes.LAUNCHES), dict(probes.ROLL_FORM_LAUNCHES)) == before


def _form_refusal(case):
    y37 = torch.as_tensor(_block((32, 37)))
    y40 = torch.as_tensor(_block((32, 40)))
    x37 = torch.as_tensor(_block((40, 37)))
    flat = torch.zeros(32 * 48 + 1)
    unaligned = flat[1:].view(32, 48)
    calls = {
        "y_wide_odd_ny": lambda: probes.roll_y(y37, 1, 6, form="wide"),
        "y_wide_ny_not_a_multiple_of_16": lambda: probes.roll_y(y40, 1, 6, form="wide"),
        "y_shuffle_with_form": lambda: probes.roll_y(y40, 1, 6, mechanism="shuffle", form="narrow"),
        "y_form_name": lambda: probes.roll_y(y40, 1, 6, form="vector"),
        "y_wide_unaligned": lambda: probes.roll_y(unaligned, 1, 6, form="wide"),
        "y_clusters_odd_ny": lambda: probes.roll_y_clusters(32, 37),
        "x_wide_odd_ny": lambda: probes.roll_x(x37, 1, 8, form="wide"),
        "x_form_name": lambda: probes.roll_x(y40, 1, 8, form="vector"),
        "x_global_with_form": lambda: probes.roll_x(y40, 1, 8, mechanism="global", form="narrow"),
        "x_wide_unaligned": lambda: probes.roll_x(unaligned, 1, 8, form="wide"),
    }
    return calls[case]


@pytest.mark.parametrize("case", [
    "y_wide_odd_ny", "y_wide_ny_not_a_multiple_of_16", "y_shuffle_with_form", "y_form_name",
    "y_wide_unaligned", "y_clusters_odd_ny", "x_wide_odd_ny", "x_form_name",
    "x_global_with_form", "x_wide_unaligned"])
def test_wide_form_refusals(case):
    """form="wide" on a shape or pointer the wide form does not take
    raises ValueError, as does a form for another mechanism or an unknown
    form; nothing is counted."""
    before = dict(probes.LAUNCHES), dict(probes.ROLL_FORM_LAUNCHES)
    with pytest.raises(ValueError):
        _form_refusal(case)()
    assert (dict(probes.LAUNCHES), dict(probes.ROLL_FORM_LAUNCHES)) == before


def test_an_unaligned_block_takes_the_narrow_form_by_default():
    """form=None on a block the wide form does not take (not 16-byte
    aligned) is the narrow form: the plain result on the CPU."""
    flat = torch.as_tensor(_block((32 * 40 + 1,), seed=7))
    x = flat[1:].view(32, 40)
    assert torch.equal(probes.roll_y(x, 3, 6), torch.roll(x, 18, 1))
    assert torch.equal(probes.roll_x(x, 3, 6), torch.roll(x, 18, 0))
