"""Eq. 10/11 over a client-stacked tree (``mix_tree``) against the JAX
package's, on the CPU.

``ops.mix_aggregate_tree`` on CPU leaves takes ``ref.mix_aggregate_tree_ref``
(ravel, ``mix_aggregate_ref``, unravel), the plain version of record.  It is
held to ``repro.kernels.ops.mix_aggregate_tree`` — its per-leaf einsum
(``implementation="ref"``) and its Pallas body in interpret mode — on the
fcn, cnn, lstm, svm, lm and lm adapter trees, at atol 1e-6 and rtol 1e-5
(fp32 sums of at most 8 terms of magnitude ≤ 4, in another order).  The
CUDA kernel's table builder (leaf tiles, alignment classes, the split into
launches of at most ``MIX_TREE_L_MAX`` leaves, the packing of a host ``w``)
is pure Python and tested here; the kernel itself equals the old chain bit
for bit on the card (``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.fl import build_task_model
from repro_torch.kernels import diffusion as tdiff
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.launch import LAUNCHES
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                     # CI installs it; the image may not
    HAVE_HYPOTHESIS = False

    def _identity(f=None, **kw):        # keep the decorators importable
        return f if f is not None else _identity

    given = settings = _identity

    class st:                           # noqa: N801 - stand-in namespace
        lists = integers = tuples = staticmethod(lambda *a, **k: None)

needs_hypothesis = pytest.mark.skipif(not HAVE_HYPOTHESIS,
                                      reason="hypothesis not installed")

ATOL, RTOL = 1e-6, 1e-5
TREES = ("fcn", "cnn", "lstm", "svm", "lm", "lm_adapter")
IMPLS = ("ref", "pallas_interpret")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _template(tree: str):
    """A one-client tree of the task model (the lm adapter: its LoRA
    view), for its structure and leaf shapes."""
    model = build_task_model("lm" if tree == "lm_adapter" else tree)
    params = model.init(torch.Generator().manual_seed(0))
    if tree == "lm_adapter":
        params = model.split(params)[1]
    return params


def _stacked(tree: str, c: int, seed: int):
    """The tree's leaves stacked over C clients, numpy fp32 from one seed,
    and the tree structure."""
    leaves, treedef = tree_flatten(_template(tree))
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(c,) + tuple(x.shape)).astype(np.float32)
            for x in leaves], treedef


def _weights(g: int, c: int, seed: int) -> np.ndarray:
    """A row-stochastic (G, C) fp32 matrix, as MixOp.matrix and the
    aggregation row are."""
    w = np.random.default_rng(seed + 1).random((g, c)).astype(np.float64)
    return (w / w.sum(axis=1, keepdims=True)).astype(np.float32)


def _reference(leaves, treedef, w, impl, **kw):
    """The reference's tree mix on the same values, leaves in the port's
    order."""
    jtree = tree_unflatten(treedef, [jnp.asarray(x) for x in leaves])
    out = jops.mix_aggregate_tree(jtree, jnp.asarray(w), implementation=impl,
                                  **kw)
    return [np.asarray(x) for x in jax.tree.leaves(out)]


def _assert_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.float().numpy(), b.astype(np.float32),
                                   atol=ATOL, rtol=RTOL)


# ------------------------------------------------ the tree against repro

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", ["aggregate", "mixop"])
@pytest.mark.parametrize("tree", TREES)
def test_mix_aggregate_tree_matches_reference(tree, case, impl):
    """Eq. 11 (a (1, C) row, collapsed) and a MixOp (G = C, stacked) on
    every task tree: fp32 leaves of the right shapes within atol 1e-6,
    rtol 1e-5 of the reference, no kernel launched on the CPU."""
    c = 5
    leaves, treedef = _stacked(tree, c, seed=len(tree))
    g, collapse = (1, True) if case == "aggregate" else (c, False)
    w = _weights(g, c, seed=len(tree))
    before = dict(LAUNCHES)
    got = tops.mix_aggregate_tree(
        tree_unflatten(treedef, [torch.from_numpy(x) for x in leaves]),
        torch.from_numpy(w), collapse=collapse)
    assert LAUNCHES == before
    got = tree_leaves(got)
    assert all(x.dtype == torch.float32 for x in got)
    _assert_close(got, _reference(leaves, treedef, w, impl,
                                  collapse=collapse))


@pytest.mark.parametrize("impl", IMPLS)
def test_one_slot_mixop_stays_stacked(impl):
    """A one-slot MixOp has G = 1 too, and without ``collapse`` keeps its
    leading axis."""
    leaves, treedef = _stacked("fcn", 1, seed=3)
    w = np.ones((1, 1), np.float32)
    got = tree_leaves(tops.mix_aggregate_tree(
        tree_unflatten(treedef, [torch.from_numpy(x) for x in leaves]),
        torch.from_numpy(w)))
    assert [tuple(x.shape) for x in got] == [x.shape for x in leaves]
    _assert_close(got, _reference(leaves, treedef, w, impl))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("keep_float32", [False, True])
def test_bf16_and_non_contiguous_leaves(impl, keep_float32):
    """A bf16 leaf and a non-contiguous (transposed) leaf in the fcn tree:
    fp32 inside; ``keep_float32`` returns fp32 leaves, otherwise each
    leaf's dtype comes back, bit for bit the fp32 result cast to it."""
    c = 4
    leaves, treedef = _stacked("fcn", c, seed=11)
    t_leaves = [torch.from_numpy(x) for x in leaves]
    bf = 1                                  # the (64, 128) first weight
    t_leaves[bf] = t_leaves[bf].to(torch.bfloat16)
    leaves[bf] = t_leaves[bf].float().numpy()
    tr = max(range(len(leaves)), key=lambda i: leaves[i].size)
    t_leaves[tr] = torch.from_numpy(
        np.ascontiguousarray(leaves[tr].transpose(0, 2, 1))).transpose(1, 2)
    assert not t_leaves[tr].is_contiguous()
    w = _weights(c, c, seed=11)
    got = tree_leaves(tops.mix_aggregate_tree(
        tree_unflatten(treedef, t_leaves), torch.from_numpy(w),
        keep_float32=keep_float32))
    want_dtype = [torch.float32 if keep_float32 else x.dtype
                  for x in t_leaves]
    assert [x.dtype for x in got] == want_dtype
    f32 = tree_leaves(tops.mix_aggregate_tree(
        tree_unflatten(treedef, t_leaves), torch.from_numpy(w),
        keep_float32=True))
    assert torch.equal(got[bf], f32[bf].to(got[bf].dtype))
    _assert_close(f32, _reference(leaves, treedef, w, impl,
                                  keep_float32=True))


def test_cpu_route_is_the_plain_version_of_record():
    """On the CPU ``ops.mix_aggregate_tree`` is ``mix_aggregate_tree_ref``,
    which is ravel → ``mix_aggregate_ref`` → unravel, bit for bit."""
    leaves, treedef = _stacked("lm", 3, seed=5)
    tree = tree_unflatten(treedef, [torch.from_numpy(x) for x in leaves])
    w = torch.from_numpy(_weights(3, 3, seed=5))
    got = tree_leaves(tops.mix_aggregate_tree(tree, w))
    flat, spec = tdiff.stack_ravel(tree)
    want = tree_leaves(tdiff.stack_unravel(tref.mix_aggregate_ref(flat, w),
                                           spec))
    assert len(got) == len(want) == 37
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(tref.mix_aggregate_tree_ref(tree, w)), want))


# --------------------------------------------------------- table builder

FCN_NUMELS = [128, 8192, 128, 16384, 10, 1280]


def _ptrs(numels, base: int, misalign=()):
    """Addresses of leaves laid out one after another from ``base``, each
    start rounded up to 512 bytes, plus 4 bytes for the indices in
    ``misalign``."""
    out, at = [], base
    for i, n in enumerate(numels):
        out.append(at + (4 if i in misalign else 0))
        at += -(-(4 * max(n, 1) * 16 + 8) // 512) * 512
    return out


def test_table_of_the_fcn_tree():
    """C ≤ 8: 256 columns a tile; every leaf takes 16-byte loads but the
    (10,) bias.  C > 8: 128 columns a tile."""
    xp, op = _ptrs(FCN_NUMELS, 1 << 20), _ptrs(FCN_NUMELS, 1 << 30)
    (t,) = tdiff.mix_tree_table(FCN_NUMELS, xp, op, 8)
    assert t.leaves == tuple(range(6))
    assert t.tile0.tolist() == [0, 1, 33, 34, 98, 99, 104]
    assert t.vec.tolist() == [1, 1, 1, 1, 0, 1]
    assert t.n.tolist() == FCN_NUMELS
    assert t.x.tolist() == xp and t.out.tolist() == op
    assert t.tile0.dtype == t.n.dtype == t.vec.dtype == np.int32
    (t,) = tdiff.mix_tree_table(FCN_NUMELS, xp, op, 9)
    assert t.tile0.tolist() == [0, 1, 65, 66, 194, 195, 205]


def test_table_alignment_classes_and_empty_leaves():
    """A base off 16 bytes on either side loses the 16-byte loads; an
    empty leaf gets no entry."""
    numels = [16, 0, 16, 16, 7]
    (t,) = tdiff.mix_tree_table(numels, _ptrs(numels, 4096, misalign={2}),
                                _ptrs(numels, 8192, misalign={3}), 4)
    assert t.leaves == (0, 2, 3, 4)
    assert t.vec.tolist() == [1, 0, 0, 0]
    assert t.tile0.tolist() == [0, 1, 2, 3, 4]
    assert tdiff.mix_tree_table([0, 0], [0, 0], [0, 0], 4) == []


def test_table_splits_into_launches_of_at_most_l_max_leaves():
    numels = [1 + i % 300 for i in range(150)]
    xp, op = _ptrs(numels, 1 << 20), _ptrs(numels, 1 << 32)
    table = tdiff.mix_tree_table(numels, xp, op, 16)
    assert [len(t.leaves) for t in table] == [64, 64, 22]
    assert sum((t.leaves for t in table), ()) == tuple(range(150))
    for t in table:
        assert t.tile0[0] == 0
        assert (np.diff(t.tile0) == -(-t.n // 128)).all()


def _covered(t, cols: int):
    """Run the kernel's block → (leaf, columns) map over a launch's tiles:
    the leaf of tile b is the count of first tiles ≤ b, less one (the two
    ballots of ``tree_leaf``); returns each leaf's columns written."""
    seen = {i: np.zeros(n, int) for i, n in zip(t.leaves, t.n.tolist())}
    for b in range(int(t.tile0[-1])):
        j = int((t.tile0[:-1] <= b).sum()) - 1
        lo = (b - int(t.tile0[j])) * cols
        assert lo < t.n[j]                  # no block without work
        seen[t.leaves[j]][lo:lo + cols] += 1
    return seen


@needs_hypothesis
@settings(max_examples=60, deadline=None)
@given(numels=st.lists(st.integers(0, 3000), min_size=1, max_size=140),
       c=st.integers(1, 40),
       misalign=st.lists(st.integers(0, 139), max_size=10))
def test_table_properties(numels, c, misalign):
    """On drawn trees: every leaf with elements appears once, in order, in
    launches of at most L_MAX leaves; tiles are ⌈n / cols⌉; 16-byte loads
    exactly where n % 4 == 0 and both bases are 16-byte aligned; the
    kernel's tile → leaf map writes every column of every leaf once."""
    cols = tdiff.mix_tree_tile_cols(c)
    assert cols == (256 if c <= 8 else 128)
    xp = _ptrs(numels, 1 << 24, misalign=set(misalign))
    op = _ptrs(numels, 1 << 34, misalign={i // 2 for i in misalign})
    table = tdiff.mix_tree_table(numels, xp, op, c)
    assert sum((t.leaves for t in table), ()) == tuple(
        i for i, n in enumerate(numels) if n > 0)
    for t in table:
        assert 1 <= len(t.leaves) <= tdiff.MIX_TREE_L_MAX
        assert (np.diff(t.tile0) == -(-t.n // cols)).all()
        for j, i in enumerate(t.leaves):
            assert t.vec[j] == (numels[i] % 4 == 0 and xp[i] % 16 == 0
                                and op[i] % 16 == 0)
        for i, hits in _covered(t, cols).items():
            assert (hits == 1).all(), i


def test_host_w_packs_into_the_parameters():
    """A host ``w`` of G·C ≤ W_MAX values goes as fp32 row-major values;
    a larger one, or one already on a device, as an fp32 tensor there."""
    w = torch.from_numpy(_weights(8, 8, seed=2)).double()
    host, dev = tdiff.mix_tree_weights(w, torch.device("cpu"))
    assert dev is None and host.dtype == np.float32 and host.shape == (64,)
    assert np.array_equal(host, w.float().numpy().reshape(-1))
    col = torch.from_numpy(_weights(8, 1, seed=2)).t()     # strided view
    host, _ = tdiff.mix_tree_weights(col, torch.device("cpu"))
    assert np.array_equal(host, col.contiguous().numpy().reshape(-1))
    edge = torch.rand((1, tdiff.MIX_TREE_W_MAX))
    assert tdiff.mix_tree_weights(edge, torch.device("cpu"))[1] is None
    big = torch.rand((1, tdiff.MIX_TREE_W_MAX + 1), dtype=torch.float64)
    host, dev = tdiff.mix_tree_weights(big, torch.device("cpu"))
    assert host is None and dev.dtype == torch.float32
    assert dev.is_contiguous() and torch.equal(dev, big.float())


# ------------------------------------------------------------ refusals

def test_cuda_wrapper_refusals_without_a_card():
    """Shapes are checked before devices: leaves of different leading axes
    and a ``w`` that does not match are refused as such, then CPU leaves
    because they are not on the card — all before ``nvcc`` is needed."""
    tree = {"a": torch.zeros((4, 3)), "b": torch.zeros((4,))}
    with pytest.raises(ValueError, match="leading client axis"):
        tdiff.mix_aggregate_tree_cuda({"a": torch.zeros((4, 3)),
                                       "b": torch.zeros((5,))},
                                      torch.ones((1, 4)))
    for w in (torch.ones((1, 5)), torch.ones(4), torch.ones((0, 4))):
        with pytest.raises(ValueError, match="does not match"):
            tdiff.mix_aggregate_tree_cuda(tree, w)
    with pytest.raises(ValueError, match="collapse"):
        tdiff.mix_aggregate_tree_cuda(tree, torch.ones((2, 4)),
                                      collapse=True)
    with pytest.raises(ValueError, match="CUDA"):
        tdiff.mix_aggregate_tree_cuda(tree, torch.ones((1, 4)))
    with pytest.raises(ValueError, match="at least one leaf"):
        tdiff.mix_aggregate_tree_cuda({}, torch.ones((1, 4)))
