"""The port's int8 hop wire against the JAX package's, on the CPU.

``quant_pack`` / ``quant_unpack``: the plain versions and the CPU dispatch
(``repro_torch.kernels.ref`` / ``ops``) against ``repro.kernels.ref`` and
the Pallas bodies in interpret mode, bit for bit — codes, scales and
decoded values — with all-zero rows, exact .5 ties after scaling and values
at the ±127 clip.  The packing layer (``repro_torch.fl.adapters``) against
``repro.fl.adapters``: padding, ``packed_bits`` from shapes, and the slot
and tree roundtrips sharing one block layout.  The CUDA kernels equal these
plain versions bit for bit on the card (``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import adapters as jad
from repro.kernels import ref as jref
from repro.kernels.quant import quant_pack_pallas, quant_unpack_pallas
from repro_torch.fl import adapters as tad
from repro_torch.kernels import LAUNCHES, QUANT_BLOCK
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant as tquant
from repro_torch.kernels import ref as tref
from repro_torch.tree import tree_leaves, tree_map


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rows(r, b, seed):
    """Rows of random scale; row 0 all zero; where the row has room, a row
    whose scale is exactly 1/8 (absmax 15.875 = 127/8) holding .5 ties
    after scaling and both clip ends ±127."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(r, b)).astype(np.float32) * rng.uniform(
        0.01, 100.0, size=(r, 1)).astype(np.float32)
    x[0] = 0.0
    if r > 1:
        ties = (np.arange(b) % 9 - 4.5).astype(np.float32) / np.float32(8.0)
        ties[0], ties[-1] = 15.875, -15.875
        x[1] = ties
    return x


@pytest.mark.parametrize("r,b", [(1, 512), (7, 512), (16, 128), (3, 8)])
def test_quant_plain_matches_reference_bitwise(r, b):
    x = _rows(r, b, seed=r * 1000 + b)
    q_r, s_r = (np.array(a) for a in jref.quant_pack_ref(jnp.asarray(x)))
    q_p, s_p = (np.array(a) for a in quant_pack_pallas(jnp.asarray(x),
                                                         interpret=True))
    for q, s in (tref.quant_pack_ref(torch.from_numpy(x)),
                 tops.quant_pack(torch.from_numpy(x))):
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        for want_q, want_s in ((q_r, s_r), (q_p, s_p)):
            np.testing.assert_array_equal(q.numpy(), want_q)
            np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                          want_s.view(np.uint32))
    np.testing.assert_array_equal(q_r[0], 0)
    if r > 1:
        # The tie row really ties: scale 1/8, codes ±k.5 → even, clip ±127.
        assert s_r[1] == np.float32(0.125)
        assert q_r[1, 0] == 127 and q_r[1, -1] == -127
        halves = (np.arange(b) % 9 - 4.5)[1:-1]
        np.testing.assert_array_equal(q_r[1, 1:-1], np.round(halves))
    out_r = np.asarray(jref.quant_unpack_ref(jnp.asarray(q_r),
                                             jnp.asarray(s_r)))
    out_p = np.asarray(quant_unpack_pallas(jnp.asarray(q_r),
                                           jnp.asarray(s_r), interpret=True))
    tq, ts = torch.from_numpy(q_r), torch.from_numpy(s_r)
    for out in (tref.quant_unpack_ref(tq, ts), tops.quant_unpack(tq, ts)):
        assert out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), out_r)
        np.testing.assert_array_equal(out.numpy(), out_p)
    np.testing.assert_array_equal(out_r[0], 0.0)


def test_scale_multiplies_by_the_float32_reciprocal():
    """The scale is ``absmax·f32(1/127)`` (bits 0x3c010204), not
    ``absmax/127``: the two differ by an ulp for some absmax values."""
    assert np.float32(tref._INV127).view(np.uint32) == 0x3C010204
    x = np.linspace(0.5, 3.0, 4096, dtype=np.float32).reshape(-1, 1)
    _, s = tref.quant_pack_ref(torch.from_numpy(x))
    np.testing.assert_array_equal(s.numpy(),
                                  x[:, 0] * np.float32(1.0 / 127.0))
    assert (s.numpy() != x[:, 0] / np.float32(127.0)).any()


def test_pack_rows_pads_to_block_multiple():
    c, f = 3, QUANT_BLOCK + 37
    flat = _rows(c, f, seed=5)
    q, s = tad.pack_rows(torch.from_numpy(flat))
    assert q.shape == (c, 2 * QUANT_BLOCK) and s.shape == (c, 2)
    np.testing.assert_array_equal(q[:, f:].numpy(), 0)
    jq, js = jad.pack_rows(jnp.asarray(flat))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    out = tad.unpack_rows(q, s, f)
    assert out.shape == (c, f)
    np.testing.assert_array_equal(out.numpy(),
                                  tad.quant_roundtrip_rows(
                                      torch.from_numpy(flat)).numpy())
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jad.quant_roundtrip_rows(jnp.asarray(flat))))


def test_packed_bits_from_shapes():
    """8·block + 32 bits per row-block from the leaves' shapes: tensors or
    anything with a ``shape`` give the reference's figure."""
    tmpl = {"a": torch.zeros((3, 100)), "b": torch.zeros((41,))}
    rows = -(-341 // QUANT_BLOCK)
    assert tad.packed_bits(tmpl) == float(rows * (8 * QUANT_BLOCK + 32))
    assert tad.packed_bits(tmpl) == jad.packed_bits(
        {"a": jnp.zeros((3, 100)), "b": jnp.zeros((41,))})
    shapes = tree_map(lambda t: np.empty(t.shape, np.float32), tmpl)
    assert tad.packed_bits(shapes) == tad.packed_bits(tmpl)
    assert tad.packed_bits({"w": torch.zeros((7 * QUANT_BLOCK,))}) == (
        7.0 * (8 * QUANT_BLOCK + 32))


def _tree(k):
    g = np.random.default_rng(k)
    return {"a": g.normal(size=(13, 5)).astype(np.float32),
            "b": [g.normal(size=(700,)).astype(np.float32),
                  g.normal(size=(2, 3)).astype(np.float32)]}


def test_slot_and_tree_roundtrips_share_block_layout():
    """A slot tree and the client-stacked tree decode to the same values,
    and both equal the reference's."""
    slots = [_tree(i) for i in range(4)]
    stacked = {"a": np.stack([s["a"] for s in slots]),
               "b": [np.stack([s["b"][j] for s in slots]) for j in (0, 1)]}
    via_tree = tad.quant_roundtrip_tree(tree_map(torch.from_numpy, stacked))
    want_tree = jad.quant_roundtrip_tree(jax.tree.map(jnp.asarray, stacked))
    for a, b in zip(tree_leaves(via_tree), jax.tree.leaves(want_tree)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for i, slot in enumerate(slots):
        via_slot = tad.quant_roundtrip_slot(tree_map(torch.from_numpy, slot))
        want_slot = jad.quant_roundtrip_slot(jax.tree.map(jnp.asarray, slot))
        for a, b, c in zip(tree_leaves(via_slot),
                           tree_leaves(tree_map(lambda x: x[i], via_tree)),
                           jax.tree.leaves(want_slot)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
            np.testing.assert_array_equal(a.numpy(), np.asarray(c))


def test_cuda_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tquant.quant_pack_cuda(torch.zeros((2, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        tquant.quant_unpack_cuda(torch.zeros((2, 8), dtype=torch.int8),
                                 torch.ones(2))
    assert {"quant_pack", "quant_unpack"} <= set(LAUNCHES)
