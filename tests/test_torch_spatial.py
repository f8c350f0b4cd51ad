"""Spatial sharding of the port (``parallel/spatial.py``,
``parallel/spatial_models.py``) against the JAX package's under
``shard_map`` and against the port's own whole-image ops.

Four gloo processes (``tests/_spatial_workers.py``, under ``spawn``) each
hold an H-slab and run every case once for the module; the JAX references
run here meanwhile, on four of the eight virtual CPU devices of
``tests/conftest.py``, with ``tests/test_spatial.py``'s shapes. Each case
compares:

  * every op (the convs, the transpose conv, instance norm, both pools,
    the pads, the halo exchange, a mini generator) to the JAX op within
    JAX's own 1e-4 (1.9e-6 read, the mini generator; 0 for the convs but
    the transpose conv's 2.4e-7, whose halo row is added apart), and to
    the whole-image op's rows within 1e-5 (1.6e-6 read), the gradients of a random projection of the output too, summed
    over the ranks (the halo exchange's backward, instance norm's and the
    gather's), within 1e-5 of their largest |value| above 1;
  * the ``global``, ``local`` and ``UNet`` slab forwards at 4 features,
    64², against JAX's ``*_sharded_apply`` on the same weights converted
    (``core/convert.py``), within JAX's 2e-3 ceiling and the 1e-5
    expected (5.5e-7-8.8e-7 read), and against the port's whole-image
    forward (≤ 7.3e-7 read) and its parameter gradients (1e-5 of the
    largest; ≤ 1.9e-6 read);
  * a 2 × 2 data × spatial grid (two process groups of two) against JAX's
    2 × 4 form of ``test_2d_mesh_data_x_spatial`` (4.2e-7 read).

The halo exchange's rows past the true edges differ by design: JAX's ring
wraps around there, the port fills zeros; ``spatial_pad`` overwrites both.
"""

import multiprocessing
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh as JMesh, PartitionSpec as P

import _spatial_workers as W
from cistar_tpu.ops import nn as jnn
from cistar_tpu.parallel import spatial as jsp
from cistar_tpu.parallel import spatial_models as jsm
from cistar_tpu_torch.core.convert import (generator_to_jax,
                                           unet_generator_hd_to_jax)
from cistar_tpu_torch.parallel import spatial as sp
from cistar_tpu_torch.parallel import spatial_models as sm

JAX_ATOL = 1e-4          # tests/test_spatial.py's
WHOLE_ATOL = 1e-5
GEN_JAX_ATOL = 2e-3      # tests/test_spatial.py's ceiling for the models
GEN_EXPECT = 1e-5
GRAD_RTOL = 1e-5
JOIN_S = 240


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_ops():
    """name → the JAX slab function of the case's arrays."""
    def pad(mode):
        return lambda s: jsp.spatial_pad(s, W.PAD, mode)

    def mini(s, w1, w2, w3, w4, w5):
        h = jnn.relu(jsp.spatial_instance_norm(
            jsp.spatial_conv2d(s, w1, None, 1, 3, "reflect")))
        h = jnn.relu(jsp.spatial_instance_norm(
            jsp.spatial_conv2d(h, w2, None, 2, 1, "zero")))
        h = h + jsp.spatial_instance_norm(
            jsp.spatial_conv2d(h, w3, None, 1, 1, "reflect"))
        h = jnn.relu(jsp.spatial_instance_norm(
            jsp.spatial_conv_transpose2d(h, w4)))
        return jnn.tanh(jsp.spatial_conv2d(h, w5, None, 1, 3, "reflect"))

    return {
        "conv_reflect_3x3": lambda s, w, b: jsp.spatial_conv2d(
            s, w, b, 1, 1, "reflect"),
        "conv_reflect_7x7": lambda s, w: jsp.spatial_conv2d(
            s, w, None, 1, 3, "reflect"),
        "conv_stride2": lambda s, w: jsp.spatial_conv2d(s, w, None, 2, 1,
                                                        "zero"),
        "conv_transpose": lambda s, w, b: jsp.spatial_conv_transpose2d(
            s, w, b),
        "instance_norm": jsp.spatial_instance_norm,
        "avg_pool_3s2": jsp.spatial_avg_pool_3s2,
        "max_pool2": jsp.spatial_max_pool2,
        "pad_reflect": pad("reflect"),
        "pad_zero": pad("zero"),
        "pad_replicate": pad("replicate"),
        "halo_exchange": lambda s: jsp.halo_exchange(s, *W.HALO),
        "mini_generator": mini,
    }


def _shard(mesh, fn, x, *consts):
    # one compiled program a case (eager shard_map compiles op by op)
    f = jax.jit(shard_map(lambda s, *c: fn(s, *c), mesh=mesh,
                          in_specs=(P(None, "spatial", None, None),)
                          + (P(),) * len(consts),
                          out_specs=P(None, "spatial", None, None),
                          check_vma=False))
    return np.asarray(f(jnp.asarray(x), *map(jnp.asarray, consts)))


def _jax_params(family, g):
    sd = g.state_dict()
    return unet_generator_hd_to_jax(sd) if family == "UNet" \
        else generator_to_jax(sd)


def _jax_gen(family, mesh, g, x):
    params = _jax_params(family, g)
    kw = W.FAMILIES[family]
    if family == "global":
        fn = jax.jit(lambda p, x: jsm.global_generator_sharded_apply(
            p, x, mesh, kw["n_downsampling"], kw["n_blocks"]))
    elif family == "local":
        fn = jax.jit(lambda p, x: jsm.local_enhancer_sharded_apply(
            p, x, mesh, **{k: kw[k] for k in (
                "n_downsample_global", "n_blocks_global",
                "n_local_enhancers", "n_blocks_local")}))
    else:
        fn = jax.jit(lambda p, x: jsm.unet_msrb_sharded_apply(
            p, x, mesh, kw["n_residual_blocks"]))
    return np.asarray(fn(params, jnp.asarray(x.numpy())))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the four ranks' results, the JAX references, the whole-image
    references)."""
    tmp = str(tmp_path_factory.mktemp("spatial"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=W.ops_worker, args=(r, tmp))
             for r in range(W.OPS_WORLD)]
    for p in procs:
        p.start()
    try:
        mesh = JMesh(np.asarray(jax.devices()[:W.OPS_WORLD]), ("spatial",))
        jops = _jax_ops()
        jax_ref = {"ops": {name: _shard(mesh, jops[name], *arrays)
                           for name, arrays in W.op_inputs().items()},
                   "gen": {f: _jax_gen(f, mesh, W.generator(f),
                                       W.gen_input())
                           for f in W.FAMILIES}}
        mesh2d = JMesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                       ("data", "spatial"))
        fn = jax.jit(shard_map(
            lambda p, s: jsm.global_generator_slab_forward(
                p, s, W.GRID["n_downsampling"], W.GRID["n_blocks"]),
            mesh=mesh2d, in_specs=(P(), P("data", "spatial", None, None)),
            out_specs=P("data", "spatial", None, None), check_vma=False))
        grid = W.generator("grid")
        x = W.gen_input(31, W.GRID_X)
        jax_ref["grid"] = np.asarray(fn(_jax_params("grid", grid),
                                        jnp.asarray(x.numpy())))
        whole = {"ops": {n: W.op_whole(n) for n in W.op_inputs()},
                 "gen": {f: W.gen_whole(f) for f in W.FAMILIES}}
        with torch.no_grad():
            whole["grid"] = grid(x)
    finally:
        for p in procs:
            p.join(timeout=JOIN_S)
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
    assert not hung, "a spatial worker hung"
    assert [p.exitcode for p in procs] == [0] * W.OPS_WORLD
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
             for r in range(W.OPS_WORLD)]
    return ranks, jax_ref, whole


def _edge_rows(n_rows):
    """The halo exchange's rows past the true edges, in the gathered
    layout: rank 0's first HALO[0], the last rank's last HALO[1]."""
    keep = np.ones(n_rows, bool)
    keep[:W.HALO[0]] = False
    keep[n_rows - W.HALO[1]:] = False
    return keep


@pytest.mark.parametrize("name", list(W.op_inputs()))
def test_op_matches_jax(runs, name):
    ranks, jax_ref, _ = runs
    got, want = ranks[0]["ops"][name][0].numpy(), jax_ref["ops"][name]
    assert got.shape == want.shape
    if name == "halo_exchange":
        keep = _edge_rows(got.shape[1])
        got, want = got[:, keep], want[:, keep]
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_ATOL)


@pytest.mark.parametrize("name", list(W.op_inputs()))
def test_op_matches_whole_image(runs, name):
    ranks, _, whole = runs
    out, grads = ranks[0]["ops"][name]
    want, want_grads = whole["ops"][name]
    torch.testing.assert_close(out, want, rtol=0, atol=WHOLE_ATOL)
    for g, w in zip(grads, want_grads, strict=True):
        torch.testing.assert_close(g, w, rtol=0, atol=WHOLE_ATOL
                                   * max(1.0, float(w.abs().max())))


@pytest.mark.parametrize("family", list(W.FAMILIES))
def test_slab_forward_matches_jax(runs, family):
    ranks, jax_ref, _ = runs
    got, want = ranks[0]["gen"][family][0].numpy(), jax_ref["gen"][family]
    assert got.shape == want.shape == (1, W.GEN_SIZE, W.GEN_SIZE, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=GEN_JAX_ATOL)
    assert np.abs(got - want).max() <= GEN_EXPECT


@pytest.mark.parametrize("family", list(W.FAMILIES))
def test_slab_forward_matches_whole_image(runs, family):
    ranks, _, whole = runs
    out, grads = ranks[0]["gen"][family]
    want, want_grads = whole["gen"][family]
    torch.testing.assert_close(out, want, rtol=0, atol=GEN_EXPECT)
    scale = max(float(w.abs().max()) for w in want_grads)
    for g, w in zip(grads, want_grads, strict=True):
        assert float((g - w).abs().max()) <= GRAD_RTOL * scale


def test_2d_mesh_data_x_spatial(runs):
    ranks, jax_ref, whole = runs
    got = torch.cat([ranks[0]["grid"], ranks[2]["grid"]])
    assert got.shape == W.GRID_X
    np.testing.assert_allclose(got.numpy(), jax_ref["grid"], rtol=0,
                               atol=GEN_JAX_ATOL)
    torch.testing.assert_close(got, whole["grid"], rtol=0, atol=GEN_EXPECT)
    # the two ranks of a data shard hold the same gathered image
    assert torch.equal(ranks[0]["grid"], ranks[1]["grid"])
    assert torch.equal(ranks[2]["grid"], ranks[3]["grid"])


def test_ranks_gather_the_same_outputs(runs):
    ranks = runs[0]
    for res in ranks[1:]:
        for kind in ("ops", "gen"):
            for name, (out, grads) in res[kind].items():
                assert torch.equal(out, ranks[0][kind][name][0]), name
                for g, g0 in zip(grads, ranks[0][kind][name][1]):
                    assert torch.equal(g, g0), name


# --------------------------------------------------------------------------- #
# the slab shapes the JAX code assumes without checking
# --------------------------------------------------------------------------- #
W7 = torch.zeros(4, 1, 7, 7)


@pytest.mark.parametrize("rows,call,what", [
    (2, lambda x: sp.halo_exchange(x, 3, 3), "halo of 3 rows"),
    (2, lambda x: sp.spatial_conv2d(x, W7, None, 1, 3, "zero"),
     "halo of 3 rows"),
    (3, lambda x: sp.spatial_pad(x, 3, "reflect"), "reflect pad of 3"),
    (6, lambda x: sp.spatial_conv2d(x, torch.zeros(4, 1, 3, 3), None, 4, 1),
     "stride 4"),
    (5, lambda x: sp.spatial_avg_pool_3s2(x), "stride-2 pool"),
    (5, lambda x: sp.spatial_max_pool2(x), "2x2 pool"),
])
def test_thin_or_odd_slab_raises(rows, call, what):
    with pytest.raises(ValueError, match=what):
        call(torch.zeros(1, rows, 8, 1))


@pytest.mark.parametrize("family,rows", [("global", 62), ("local", 60),
                                         ("UNet", 60)])
def test_indivisible_height_raises(family, rows):
    # JAX's rules: H divides shards · 2^downsamplings (4, 8 and 8 here)
    with pytest.raises(ValueError, match="must divide"):
        sm.generator_sharded_apply(W.generator(family),
                                   torch.zeros(1, rows, 64, 1))
