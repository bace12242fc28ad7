"""The port's one-launch int8 hop against the JAX package's, on the CPU.

``ops.quant_roundtrip`` (on the CPU ``ref.quant_roundtrip_ref``) is the
int8 hop of one PermuteOp: every row packed and unpacked per 512-element
block of its leaves, then moved.  Held bit for bit — decoded leaves, codes
and scales — to the reference's two planes:

* fleet: ``repro.fl.adapters.quant_roundtrip_tree`` then
  ``repro.distributed.fedshard.diffuse_params``;
* host: ``repro.fl.adapters.quant_roundtrip_slot`` per slot, then the
  reorder;

on the fcn and lm adapter trees and a one-leaf tree, with blocks that
straddle leaves, F not a multiple of 4 or 512, all-zero blocks (the ε
floor), exact half-way ties, ±127 clipping, ±0 and subnormals, under the
identity and a permutation.  The adapters' new entry points
(``quant_roundtrip_tree(…, src_of_dst)``, ``quant_roundtrip_slots``) equal
the old per-tree / per-slot roundtrips followed by the move; the host
plane's int8 runs match the reference's host engine.  The CUDA wrapper's
refusals are checked without a card; the kernel itself equals these plain
versions bit for bit on the card (``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.fedshard import diffuse_params as j_diffuse
from repro.fl import ExperimentSpec as JSpec
from repro.fl import FLConfig as JConfig
from repro.fl import adapters as jad
from repro.fl import run_experiment as j_run
from repro.fl.models import build_task_model as j_build
from repro_torch.fl import (ExperimentSpec, FLConfig, build_task_model,
                            params_from_numpy, params_to_numpy,
                            run_experiment)
from repro_torch.fl import adapters as tad
from repro_torch.kernels import LAUNCHES, QUANT_BLOCK
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant as tquant
from repro_torch.kernels import ref as tref
from repro_torch.tree import tree_flatten, tree_leaves, tree_map


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _shapes(tree: str) -> list[tuple]:
    """Leaf shapes in ``stack_ravel``'s order: the fcn model (F = 26122;
    leaves at offsets 128, 8320, 8448, 24832, 24842, so blocks straddle
    them and the last leaf starts off a multiple of 4), the lm task's LoRA
    adapter (24 leaves, F = 3584 = 7 blocks) and one leaf of 1041 elements
    (3 blocks, F not a multiple of 4 or 512)."""
    if tree == "one_leaf":
        return [(1041,)]
    model = build_task_model(tree)
    params = model.init(torch.Generator().manual_seed(0))
    if model.split is not None:
        params = model.split(params)[1]
    return [tuple(x.shape) for x in tree_leaves(params)]


def _row(f: int, r: int, kind: str, rng) -> np.ndarray:
    """One flat row of F fp32 values.  ``random``: blocks of random scale.
    ``special``: the same, with block types placed by the row index r —
    an all-zero block, a block of exact half-way ties after scaling (scale
    1/8, codes k + ½ → even, both clip ends ±127), a block holding ±0 and
    subnormals among normal values, a block of subnormals only (the ε
    floor), and a block of ±absmax, every code at the ±127 clip."""
    nb = -(-f // QUANT_BLOCK)
    x = np.zeros(nb * QUANT_BLOCK, np.float32)
    for b in range(nb):
        x[b * QUANT_BLOCK:(b + 1) * QUANT_BLOCK] = rng.normal(
            size=QUANT_BLOCK).astype(np.float32) * np.float32(
                10.0 ** rng.uniform(-2, 2))
    if kind == "special":
        blk = [slice(((r + t) % nb) * QUANT_BLOCK,
                     ((r + t) % nb + 1) * QUANT_BLOCK) for t in range(5)]
        ties = (np.arange(QUANT_BLOCK) % 9 - 4.5).astype(np.float32) / 8
        ties[0], ties[-1] = 15.875, -15.875
        signed0 = x[blk[2]].copy()
        signed0[::7] = 0.0
        signed0[3::7] = -0.0
        signed0[5::11] = np.float32(3e-39) * np.sign(signed0[5::11] + 0.5)
        clip = np.full(QUANT_BLOCK, 5.0, np.float32)
        clip[1::2] = -5.0
        for s, v in ((blk[0], 0.0), (blk[1], ties), (blk[2], signed0),
                     (blk[3], np.float32(1e-40) * rng.choice(
                         [-1.0, 1.0], QUANT_BLOCK).astype(np.float32)),
                     (blk[4], clip)):
            x[s] = v
    return x[:f]


def _stacked(tree: str, kind: str, c: int, seed: int) -> list[np.ndarray]:
    """L leaves (C, *shape): row c of the flat (C, F) block cut in order."""
    shapes = _shapes(tree)
    f = sum(int(np.prod(s)) for s in shapes)
    rng = np.random.default_rng(seed)
    flat = np.stack([_row(f, r, kind, rng) for r in range(c)])
    leaves, off = [], 0
    for s in shapes:
        n = int(np.prod(s))
        leaves.append(np.ascontiguousarray(
            flat[:, off:off + n].reshape((c,) + s)))
        off += n
    return leaves


C = 6
SRC = {"identity": None, "permuted": np.array([3, 0, 5, 1, 4, 2])}
TREES = ("fcn", "lm", "one_leaf")


def _src_or_identity(src):
    return np.arange(C) if src is None else src


@pytest.mark.parametrize("rows", sorted(SRC))
@pytest.mark.parametrize("kind", ["random", "special"])
@pytest.mark.parametrize("tree", TREES)
def test_roundtrip_matches_reference_fleet(tree, kind, rows):
    """Client-stacked leaves: the reference's ``quant_roundtrip_tree`` then
    ``diffuse_params``, and ``pack_rows`` of the gathered rows."""
    leaves = _stacked(tree, kind, C, seed=len(tree) * 10 + len(kind))
    src = SRC[rows]
    j_leaves = [jnp.asarray(x) for x in leaves]
    want = j_diffuse(jad.quant_roundtrip_tree(j_leaves),
                     jnp.asarray(_src_or_identity(src)))
    t_leaves = [torch.from_numpy(x) for x in leaves]
    got, codes, scales = tref.quant_roundtrip_ref(t_leaves, src)
    via_ops = tops.quant_roundtrip(t_leaves, src)
    for a, b, w in zip(got, via_ops, want):
        assert a.dtype == torch.float32 and a.shape == w.shape
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(w).view(np.uint32))
        np.testing.assert_array_equal(b.numpy().view(np.uint32),
                                      np.asarray(w).view(np.uint32))
    flat = np.concatenate([x.reshape(C, -1) for x in leaves], axis=1)
    jq, js = jad.pack_rows(jnp.asarray(flat[_src_or_identity(src)]))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scales.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    assert codes.shape == (C, -(-flat.shape[1] // QUANT_BLOCK) * QUANT_BLOCK)


@pytest.mark.parametrize("rows", sorted(SRC))
@pytest.mark.parametrize("kind", ["random", "special"])
@pytest.mark.parametrize("tree", TREES)
def test_roundtrip_matches_reference_host(tree, kind, rows):
    """Separate slot trees: the reference's ``quant_roundtrip_slot`` per
    slot, then ``new[c] = old[src_of_dst[c]]``."""
    leaves = _stacked(tree, kind, C, seed=len(tree) * 7 + len(kind))
    src = SRC[rows]
    slots = [[np.ascontiguousarray(x[c]) for x in leaves] for c in range(C)]
    j_out = [jad.quant_roundtrip_slot([jnp.asarray(x) for x in s])
             for s in slots]
    want = [j_out[int(c)] for c in _src_or_identity(src)]
    rows_t = [[torch.from_numpy(x) for x in s] for s in slots]
    got = tops.quant_roundtrip(rows_t, src)
    assert [tuple(x.shape[1:]) for x in got] == [x.shape for x in slots[0]]
    for c in range(C):
        for a, w in zip(got, want[c]):
            np.testing.assert_array_equal(a[c].numpy().view(np.uint32),
                                          np.asarray(w).view(np.uint32))


def test_roundtrip_decodes_special_values_as_the_reference():
    """The special blocks behave as documented, on a row of six blocks
    (blocks 0-4 one type each, block 5 ragged): all-zero and subnormal
    blocks hit the ε floor and decode to +0; ties round half to even with
    ±127 at the ends; ±0, subnormals and values under half a step among
    normal values decode to +0; a block of ±absmax codes ±127."""
    f = 5 * QUANT_BLOCK + 17
    x = _row(f, 0, "special", np.random.default_rng(0))
    got, codes, scales = tref.quant_roundtrip_ref(
        [torch.from_numpy(x)[None]])
    out, q, s = got[0][0].numpy(), codes[0].numpy(), scales[0].numpy()
    blk = [slice(t * QUANT_BLOCK, (t + 1) * QUANT_BLOCK) for t in range(6)]
    eps_scale = np.float32(1e-12) * np.float32(tref._INV127)
    for b in (0, 3):
        assert s[b] == eps_scale
        np.testing.assert_array_equal(out[blk[b]].view(np.uint32), 0)
    assert s[1] == np.float32(0.125)
    np.testing.assert_array_equal(q[blk[1]][1:-1], np.round(
        (np.arange(QUANT_BLOCK) % 9 - 4.5)[1:-1]))
    assert q[blk[1]][0] == 127 and q[blk[1]][-1] == -127
    small = np.abs(x[blk[2]]) < s[2] / 2
    assert (np.signbit(x[blk[2]]) & small).any()
    assert (np.abs(x[blk[2]][small]) > 0).any()
    np.testing.assert_array_equal(out[blk[2]][small].view(np.uint32), 0)
    np.testing.assert_array_equal(np.abs(q[blk[4]]), 127)
    np.testing.assert_array_equal(q[f:], 0)
    want = jad.quant_roundtrip_rows(jnp.asarray(x[None]))
    np.testing.assert_array_equal(out.view(np.uint32),
                                  np.asarray(want)[0].view(np.uint32))


@pytest.mark.parametrize("tree", ["fcn", "lm"])
def test_adapter_entry_points_equal_the_old_roundtrip_and_move(tree):
    """``quant_roundtrip_tree(params, src_of_dst)`` equals the old tree
    roundtrip followed by ``diffuse_params``'s gather, and
    ``quant_roundtrip_slots`` equals ``quant_roundtrip_slot`` per slot
    followed by the reorder, bit for bit; slot c of the latter is row c of
    the former."""
    leaves = [torch.from_numpy(x) for x in _stacked(tree, "special", C, 3)]
    src = SRC["permuted"]
    names = [f"w{i}" for i in range(len(leaves))]
    params = dict(zip(names, leaves))
    tree_out = tad.quant_roundtrip_tree(params, src)
    idx = torch.as_tensor(src)
    old = tree_map(lambda x: x.index_select(0, idx),
                   tad.quant_roundtrip_tree(params))
    for k in names:
        assert torch.equal(tree_out[k].view(torch.int32),
                           old[k].view(torch.int32))
    slots = [{k: v[c].clone() for k, v in params.items()} for c in range(C)]
    # After a MixOp host slots alias one another: the inputs are only read.
    slots[4] = slots[1]
    before = [{k: v.clone() for k, v in s.items()} for s in slots]
    new = tad.quant_roundtrip_slots(slots, src)
    per_slot = [tad.quant_roundtrip_slot(s) for s in slots]
    for c in range(C):
        want = per_slot[int(src[c])]
        for k in names:
            assert torch.equal(new[c][k].view(torch.int32),
                               want[k].view(torch.int32))
        for k in names:
            assert torch.equal(slots[c][k], before[c][k])
    stacked_slots = tad.quant_roundtrip_tree(
        {k: torch.stack([s[k] for s in slots]) for k in names}, src)
    for c in range(C):
        for k in names:
            assert torch.equal(new[c][k], stacked_slots[k][c])


def test_int8_hop_rounds_small_lora_b_factors_to_zero():
    """The lm adapter's 512-blocks span A and B leaves, so A's absmax sets
    each block's scale; B factors of 1e-4 (zero at init, small after a
    session) sit under half a step and decode to 0 while A survives — in
    the port's hop and the reference's alike, bit for bit."""
    model = build_task_model("lm")
    adapter = model.split(model.init(torch.Generator().manual_seed(0)))[1]
    leaves, _ = tree_flatten(adapter)
    rng = np.random.default_rng(7)
    slot = [x.numpy() if x.abs().max() > 0 else
            (1e-4 * rng.normal(size=tuple(x.shape))).astype(np.float32)
            for x in leaves]
    is_b = [not bool(x.abs().max() > 0) for x in leaves]
    assert any(is_b) and not all(is_b)
    got = tad.quant_roundtrip_slots([[torch.from_numpy(x) for x in slot]],
                                    [0])[0]
    want = jad.quant_roundtrip_slot([jnp.asarray(x) for x in slot])
    for a, w, b in zip(got, want, is_b):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
        if b:
            np.testing.assert_array_equal(a.numpy(), 0.0)
        else:
            assert np.abs(a.numpy()).max() > 0.1


def test_cpu_route_keeps_leaf_dtypes_as_the_reference():
    """On the CPU a non-fp32 leaf goes through fp32 and back, as the
    reference's ``astype``; the slot path and the tree path agree."""
    rng = np.random.default_rng(11)
    slot = [rng.normal(size=(40, 3)).astype(np.float16),
            rng.normal(size=(700,)).astype(np.float32)]
    want = jad.quant_roundtrip_slot([jnp.asarray(x) for x in slot])
    got = tad.quant_roundtrip_slots([[torch.from_numpy(x) for x in slot]],
                                    [0])[0]
    for a, w in zip(got, want):
        assert a.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))


def test_cuda_wrapper_refuses_without_a_card():
    """CPU tensors, non-fp32 leaves, a mismatched ``src_of_dst`` and rows
    of different shapes are refused before anything is built or launched."""
    before = dict(LAUNCHES)
    leaves = [torch.zeros((3, 8)), torch.zeros((3, 5))]
    with pytest.raises(ValueError, match="CUDA"):
        tquant.quant_roundtrip_cuda(leaves)
    with pytest.raises(ValueError, match="CUDA"):
        tquant.quant_roundtrip_cuda([[torch.zeros(8)], [torch.zeros(8)]],
                                    [1, 0])
    with pytest.raises(ValueError, match="float32"):
        tquant.quant_roundtrip_cuda([torch.zeros((3, 8), dtype=torch.float64)])
    with pytest.raises(ValueError, match="float32"):
        tquant.quant_roundtrip_cuda([[torch.zeros(8, dtype=torch.bfloat16)]])
    for bad in ([0, 1], [0, 1, 3], [0, 1, -1], np.array([0.0, 1.0, 2.0]),
                np.zeros((3, 1), np.int64)):
        with pytest.raises(ValueError, match="src_of_dst"):
            tquant.quant_roundtrip_cuda(leaves, bad)
    with pytest.raises(ValueError, match="same shapes"):
        tquant.quant_roundtrip_cuda([[torch.zeros(8)], [torch.zeros(9)]])
    with pytest.raises(ValueError, match="leading row axis"):
        tquant.quant_roundtrip_cuda([torch.zeros((3, 8)),
                                     torch.zeros((2, 8))])
    assert LAUNCHES == before
    assert "quant_roundtrip" in LAUNCHES


def _host_specs(task: str):
    """FedDif with int8 hops on the host planes of both packages: the
    reference's ``tests/test_adapter_hops.py`` cell for lm, its fcn twin."""
    fl = dict(strategy="feddif", rounds=2, num_clients=4, num_models=4,
              seed=0, topology_seed=1, max_diffusion_rounds=3,
              hop_quant="int8")
    data = dict(task=task, alpha=0.5, dim=16 if task == "lm" else 64,
                num_samples=640)
    return (JSpec(fl=JConfig(engine="host", **fl), **data),
            ExperimentSpec(fl=FLConfig(executor="host", **fl), **data))


@pytest.mark.parametrize("task,atol,rtol", [("lm", 5e-4, 5e-3),
                                            ("fcn", 2e-4, 2e-3)])
def test_host_plane_int8_runs_match_reference(task, atol, rtol):
    """The slice as a whole on the host plane: equal ledgers and diffusion
    rounds, hop payloads within the reference's own cross-executor bars
    (lm 5e-4 / 5e-3, fcn 2e-4 / 2e-3), from the reference's init."""
    j_spec, t_spec = _host_specs(task)
    ref = j_run(j_spec)
    init = jax.tree.map(np.asarray, j_build(task).init(jax.random.PRNGKey(0)))
    port = run_experiment(t_spec, device="cpu",
                          init_fn=lambda gen: params_from_numpy(init))
    assert port.ledger.as_dict() == ref.ledger.as_dict()
    assert port.diffusion_rounds == ref.diffusion_rounds
    assert sum(port.diffusion_rounds) > 0
    ref_leaves = jax.tree.leaves(ref.final_params)
    port_leaves = tree_flatten(params_to_numpy(port.final_params))[0]
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(ref_leaves, port_leaves):
        np.testing.assert_allclose(b, np.asarray(a, np.float32), atol=atol,
                                   rtol=rtol)
