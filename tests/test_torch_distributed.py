"""The port's distribution layer against the JAX package.

- `shard_leaf` equals the JAX `shard_leaf` on the meshes 16x16, 2x16x16
  and 4x2 (a fixed grid of 240 shapes, and hypothesis where it is
  installed).
- Parameter, optimizer, cache and batch specs of the ten architectures on a
  16x16 mesh equal the JAX specs (on an `AbstractMesh`) with the group entry
  dropped from the stacked leaves. The JAX rule shards that group axis
  itself in exactly two leaves of each of grok-1-314b, llava-next-mistral-7b
  and olmoe-1b-7b (their [G, d] norm scales, G divisible by 16), which a
  per-layer port leaf cannot express; those six are pinned as the only
  differences, and `per_device_bytes` differs from the JAX sum by exactly
  their share.
- `autoshard`'s state (`active`, `logical_size`) inside, outside and after
  nested contexts is the JAX module's.
- `genfv_weighted_allreduce` on 8 gloo ranks equals `np.tensordot` and the
  JAX `genfv_weighted_allreduce` (8 host devices, in a subprocess as
  tests/test_distributed.py runs it) to 1e-6; on one rank it is the rank's
  weighted model bit for bit.
"""
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.distributed import autoshard as jax_autoshard
from repro.distributed import sharding as jax_sharding
from repro.launch import specs as jax_specs
from repro.optim import adamw as jax_adamw
from repro.optim import constant_schedule as jax_constant_schedule
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.convert import MLSTM_STATE, SLSTM_STATE, jax_leaf_map
from repro_torch.distributed import autoshard, sharding
from repro_torch.distributed.collectives import genfv_weighted_allreduce
from repro_torch.launch import specs
from repro_torch.launch.mesh import MeshSpec, make_host_mesh, make_production_mesh
from repro_torch.optim import adamw, constant_schedule
from repro_torch.tree import tree_leaves

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = sorted(list_archs())
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "4x2": (("data", "model"), (4, 2))}
# the JAX leaves whose group axis the JAX rule shards (path below a layer)
PINNED = {"grok-1-314b": {("ln1", "scale"), ("ln2", "scale")},
          "llava-next-mistral-7b": {("ln1", "scale"), ("ln2", "scale")},
          "olmoe-1b-7b": {("ln1", "scale"), ("ln2", "scale")}}


class _FakeMesh:
    """Duck-typed mesh exposing .shape for the pure sharding rules."""
    def __init__(self, shape):
        self.shape = shape


def _meshes(name):
    names, sizes = MESHES[name]
    return _FakeMesh(dict(zip(names, sizes))), MeshSpec(names, sizes)


def _padded(spec, ndim):
    """A PartitionSpec as a tuple of ndim entries."""
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


# ---------------------------------------------------------------------------
# shard_leaf
# ---------------------------------------------------------------------------
def _grid(n=240):
    """Shapes of rank 1-4 whose dims mix multiples of 16, of 2 and odd."""
    rng = np.random.default_rng(7)
    pools = [16 * rng.integers(1, 257, 64), 2 * rng.integers(1, 2049, 64),
             rng.integers(1, 4097, 64), np.array([1, 2, 4, 8, 16, 32, 3, 48])]
    out = []
    for _ in range(n):
        ndim = int(rng.integers(1, 5))
        out.append(tuple(int(rng.choice(pools[rng.integers(0, 4)])) for _ in range(ndim)))
    return out


def _same_leaf_spec(shape, name):
    fake, mesh = _meshes(name)
    for skip in (False, True):
        want = _padded(jax_sharding.shard_leaf(shape, fake, skip_leading=skip), len(shape))
        assert sharding.shard_leaf(shape, mesh, skip_leading=skip) == want, (shape, skip)


@pytest.mark.parametrize("name", list(MESHES))
def test_shard_leaf_equals_jax_on_a_grid(name):
    grid = _grid()
    assert len(set(grid)) >= 200
    for shape in grid:
        _same_leaf_spec(shape, name)


try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:       # optional in the image; the grid above holds
    pass
else:
    @given(st.lists(st.integers(1, 4096), min_size=1, max_size=4),
           st.sampled_from(list(MESHES)))
    @settings(max_examples=200, deadline=None)
    def test_shard_leaf_equals_jax_property(shape, name):
        _same_leaf_spec(tuple(shape), name)


# ---------------------------------------------------------------------------
# parameter, optimizer, cache and batch specs at full size
# ---------------------------------------------------------------------------
class _Spec:
    """A JAX spec as a leaf of the port's trees (a tuple would be a node);
    `group` is the entry of the group axis the port drops."""
    def __init__(self, spec, group=None):
        self.spec, self.group = spec, group


def _jax_spec_tree(cfg, shardings, shapes):
    """JAX shardings in the port's layout as _Spec leaves."""
    leaves = jax.tree.map(lambda s, a: _Spec(_padded(s.spec, len(a.shape))), shardings, shapes)
    tree = jax_leaf_map(cfg, leaves, row=lambda s, g: _Spec(s.spec[1:], s.spec[0]))
    for kind, layer in zip(cfg.layer_kinds, tree["layers"]):
        if isinstance(layer.get("cell"), list) and kind in ("mlstm", "slstm"):
            layer["cell"] = dict(zip(MLSTM_STATE if kind == "mlstm" else SLSTM_STATE,
                                     layer["cell"]))
    return tree


def _compare(port, jax_tree, path=()):
    """Asserts equal specs leaf by leaf; returns the paths (below the layer
    index) whose group entry the port dropped while it was not None."""
    if isinstance(port, dict):
        assert set(port) == set(jax_tree), path
        out = set()
        for k in port:
            out |= _compare(port[k], jax_tree[k], path + (k,))
        return out
    if isinstance(port, list):
        assert len(port) == len(jax_tree), path
        out = set()
        for i, (a, b) in enumerate(zip(port, jax_tree)):
            out |= _compare(a, b, path + (i,))
        return out
    assert port == jax_tree.spec, (path, port, jax_tree.spec)
    if jax_tree.group is not None:
        return {path[path.index("layers") + 2:]}
    return set()


def _jax_device_bytes(shardings, shapes, mesh_sizes):
    def one(s, a):
        parts = 1
        for e in tuple(s.spec):
            for ax in ((e,) if isinstance(e, str) else (e or ())):
                parts *= mesh_sizes[ax]
        return int(np.prod(a.shape)) * np.dtype(a.dtype).itemsize // parts
    return sum(jax.tree.leaves(jax.tree.map(one, shardings, shapes)))


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_jax_on_16x16(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jmesh = AbstractMesh((16, 16), ("data", "model"))
    mesh = make_production_mesh()
    sizes = mesh.shape

    p, jp = specs.params_specs(cfg), jax_specs.params_specs(jcfg)
    p_sh, jp_sh = sharding.params_shardings(p, mesh, cfg), jax_sharding.params_shardings(jp, jmesh)
    dropped = _compare(p_sh, _jax_spec_tree(jcfg, jp_sh, jp))
    assert dropped == PINNED.get(arch, set())

    # the port's bytes per device exceed the JAX package's by the pinned
    # leaves' share of the group axis
    extra = 0
    for grp in jp.get("groups", []):
        for path in dropped:
            leaf = grp[path[0]][path[1]]
            nbytes = int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
            extra += nbytes // sizes["model"] - nbytes // (sizes["model"] * sizes["data"])
    assert sharding.per_device_bytes(p, p_sh, mesh) == _jax_device_bytes(jp_sh, jp, sizes) + extra

    o = adamw(constant_schedule(1e-4)).init(p)
    jo = jax.eval_shape(jax_adamw(jax_constant_schedule(1e-4)).init, jp)
    o_sh, jo_sh = sharding.params_shardings(o, mesh, cfg), jax_sharding.params_shardings(jo, jmesh)
    assert o_sh["step"] == () and tuple(jo_sh["step"].spec) == ()
    assert _compare(o_sh["m"], _jax_spec_tree(jcfg, jo_sh["m"], jo["m"])) == dropped

    for B, S in ((128, 32768), (1, 524288)):
        c, jc = specs.cache_specs(cfg, B, S), jax_specs.cache_specs(jcfg, B, S)
        c_sh = sharding.cache_shardings(c, mesh)
        jc_sh = jax_sharding.cache_shardings(jc, jmesh)
        assert _compare(c_sh, _jax_spec_tree(jcfg, jc_sh, jc)) == set()
        assert sharding.per_device_bytes(c, c_sh, mesh) == _jax_device_bytes(jc_sh, jc, sizes)

    for shape in ("train_4k", "long_500k"):
        b = specs.batch_specs(cfg, INPUT_SHAPES[shape], train=shape == "train_4k")
        jb = jax_specs.batch_specs(jcfg, JAX_SHAPES[shape], train=shape == "train_4k")
        b_sh, jb_sh = sharding.batch_shardings(b, mesh), jax_sharding.batch_shardings(jb, jmesh)
        assert b_sh == {k: _padded(jb_sh[k].spec, len(jb[k].shape)) for k in jb}
        assert sharding.per_device_bytes(b, b_sh, mesh) == _jax_device_bytes(jb_sh, jb, sizes)


def test_replicated_and_describe():
    mesh = make_host_mesh()
    cfg = get_config("qwen1.5-0.5b").reduced()
    p = specs.params_specs(cfg)
    rep = sharding.replicated(p, mesh)
    assert rep["embed"] == (None, None) and rep["final_norm"]["scale"] == (None,)
    assert rep["layers"][1]["attn"]["bq"] == (None,)
    assert sharding.per_device_bytes(p, rep, mesh) == sum(
        t.numel() * t.element_size() for t in tree_leaves(p))
    text = sharding.describe(sharding.params_shardings(p, make_production_mesh(), cfg), 3)
    assert text.splitlines()[0].startswith("embed: ") and len(text.splitlines()) == 3


def test_meshes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).size == 512
    host = make_host_mesh()
    assert host.shape == {"data": 1, "model": 1} and host.name == "1x1"
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    with pytest.raises(ValueError):
        make_host_mesh(data=n + 1)


# ---------------------------------------------------------------------------
# autoshard
# ---------------------------------------------------------------------------
def test_autoshard_state_equals_jax():
    def states(mod):
        def now():
            return (mod.active(), mod.logical_size("batch"), mod.logical_size("model"),
                    mod.logical_size("other"))
        out = [now()]
        pod = _FakeMesh({"pod": 2, "data": 16, "model": 16})
        with mod.activation_sharding(_FakeMesh({"data": 16, "model": 16})):
            out.append(now())
            with mod.activation_sharding(pod):
                out.append(now())
                with mod.activation_sharding(pod, batch_axes=("data",), model_axis="nope"):
                    out.append(now())
                out.append(now())
            out.append(now())
            try:
                with mod.activation_sharding(_FakeMesh({"x": 4})):
                    out.append(now())
                    raise KeyError("inside")
            except KeyError:
                pass
            out.append(now())
        out.append(now())
        return out

    assert states(autoshard) == states(jax_autoshard)
    x = torch.ones(4, 3)
    with autoshard.activation_sharding(make_production_mesh()):
        assert autoshard.aconstrain(x, ("batch", "model")) is x


# ---------------------------------------------------------------------------
# the weighted all-reduce
# ---------------------------------------------------------------------------
def _inputs(n):
    """The cohort models and weights of tests/test_distributed.py."""
    rng = np.random.default_rng(0)
    models = {"w": rng.normal(size=(n, 4, 3)).astype(np.float32),
              "b": rng.normal(size=(n, 5)).astype(np.float32)}
    return models, rng.dirichlet(np.ones(n)).astype(np.float32)


_GLOO = r"""
import os, sys
sys.path.insert(0, "src")
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from repro_torch.distributed.collectives import genfv_weighted_allreduce


def run(rank, world, port, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        rng = np.random.default_rng(0)
        models = {"w": rng.normal(size=(world, 4, 3)).astype(np.float32),
                  "b": rng.normal(size=(world, 5)).astype(np.float32)}
        weights = rng.dirichlet(np.ones(world)).astype(np.float32)
        mine = {k: torch.from_numpy(v[rank]) for k, v in models.items()}
        got = genfv_weighted_allreduce(mine, float(weights[rank]))
        np.savez(os.path.join(out, f"rank{rank}.npz"), **{k: v.numpy() for k, v in got.items()})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.start_processes(run, args=(8, int(sys.argv[1]), sys.argv[2]), nprocs=8,
                       start_method="spawn")
"""

_JAX = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.collectives import genfv_weighted_allreduce
mesh = jax.make_mesh((8,), ("data",))
rng = np.random.default_rng(0)
models = {"w": jnp.asarray(rng.normal(size=(8, 4, 3)).astype(np.float32)),
          "b": jnp.asarray(rng.normal(size=(8, 5)).astype(np.float32))}
weights = jnp.asarray(rng.dirichlet(np.ones(8)).astype(np.float32))
out = genfv_weighted_allreduce(models, weights, mesh, axes=("data",))
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    return env


def test_weighted_allreduce_8_gloo_ranks_equals_jax(tmp_path):
    script = tmp_path / "gloo_allreduce.py"
    script.write_text(textwrap.dedent(_GLOO))
    r = subprocess.run([sys.executable, str(script), str(_free_port()), str(tmp_path)],
                       cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    jax_out = tmp_path / "jax.npz"
    r = subprocess.run([sys.executable, "-c", _JAX, str(jax_out)], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    want_jax = np.load(jax_out)
    models, weights = _inputs(8)
    for rank in range(8):
        got = np.load(tmp_path / f"rank{rank}.npz")
        for k in ("w", "b"):
            ref = np.tensordot(weights, models[k], axes=(0, 0))
            np.testing.assert_allclose(got[k], ref, rtol=0, atol=1e-6)
            np.testing.assert_allclose(got[k], want_jax[k], rtol=0, atol=1e-6)


def test_weighted_allreduce_one_rank_is_bitwise():
    models, weights = _inputs(1)
    model = {"w": torch.from_numpy(models["w"][0]).to(torch.bfloat16),
             "b": torch.from_numpy(models["b"][0])}
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        got = genfv_weighted_allreduce(model, float(weights[0]))
    finally:
        dist.destroy_process_group()
    w = torch.tensor(float(weights[0]), dtype=torch.float32)
    for k in ("w", "b"):
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], model[k].float() * w)
