"""The sharded population engine's layout in the port against the
reference, on the CPU: the fleet meshes (``launch/mesh.py``), the
logical-axis rules (``launch/sharding.py``) over every config's param
specs, the engine's construction, and capacity planning on a mesh.

The reference's meshes are built over its one CPU device repeated, as its
own tests build them (``tests/test_sharding.py``, ``tests/test_fleet.py``);
the port's over ``["cpu"] * n``. The engine's results are held to the
reference's vmap engine in ``tests/test_torch_efat.py`` and
``tests/test_torch_lm_fat.py``.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from repro.configs import get_arch as jax_get_arch
from repro.fleet import ShardedPopulationEngine as JaxShardedPopulationEngine
from repro.fleet import FleetScheduler as JaxFleetScheduler
from repro.fleet import suggest_population_size as jax_suggest
from repro.launch import mesh as JMesh
from repro.launch.sharding import make_rules_for_mesh as jax_rules
from repro.launch.sharding import resolve_spec as jax_resolve
from repro.models import model as JM
from repro.models.classifier import classifier_param_axes as jax_classifier_param_axes
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.optimizer import opt_state_specs as jax_opt_state_specs
from repro_torch.configs import get_arch, list_archs
from repro_torch.fleet import FleetScheduler, ShardedPopulationEngine, suggest_population_size
from repro_torch.launch.mesh import Mesh, make_fleet_mesh, make_host_mesh, make_pop_mesh
from repro_torch.launch.sharding import (
    current_mesh_context,
    make_rules_for_mesh,
    mesh_context,
    resolve_spec,
    tree_specs,
)
from repro_torch.models.classifier import classifier_param_axes, init_classifier
from repro_torch.models.model import Model, param_specs
from repro_torch.train.optimizer import AdamWConfig, adamw_init, opt_state_specs
from repro_torch.train.population import make_fat_engine

ARCHS = list_archs(include_paper=True)
MLP = get_arch("paper-mlp")
CPU = torch.device("cpu")


def _jax_mesh(shape, axes):
    return JaxMesh(np.array([jax.devices()[0]] * int(np.prod(shape))).reshape(shape), axes)


def _mesh(shape, axes):
    grid = np.empty(int(np.prod(shape)), dtype=object)
    grid[:] = [CPU] * grid.size
    return Mesh(grid.reshape(shape), axes)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


def _outcome(fn):
    """A mesh's (axis names, shape), or the ValueError's first clause (the
    reference's hint after ';' names XLA flags, the port's a device list)."""
    try:
        m = fn()
    except ValueError as e:
        return "ValueError", str(e).split(";")[0]
    return tuple(m.axis_names), tuple(m.devices.shape)


MESH_CASES = [
    ("pop", dict()), ("pop", dict(num_devices=2)), ("pop", dict(num_devices=5)), ("pop", dict(num_devices=0)),
    ("pop", dict(num_devices=-2)), ("pop", dict(num_devices="four")), ("pop", dict(axis="rows")),
    ("fleet", dict()), ("fleet", dict(pop=None, model=3)), ("fleet", dict(pop=2, model=2)),
    ("fleet", dict(pop=5, model=1)), ("fleet", dict(pop=1, model=5)), ("fleet", dict(pop=1, model=0)),
    ("fleet", dict(pop="4x2")), ("fleet", dict(pop=None, model="x")),
    ("fleet", dict(pop=1, model=1, axis_names=("pop",))), ("fleet", dict(pop=1, model=1, axis_names=("a", "b"))),
]


@pytest.mark.parametrize("n", [1, 4, 8])
@pytest.mark.parametrize("kind,kw", MESH_CASES, ids=[f"{k}-{kw}" for k, kw in MESH_CASES])
def test_fleet_meshes_clamp_and_raise_as_the_reference(monkeypatch, n, kind, kw):
    port_fn = {"pop": make_pop_mesh, "fleet": make_fleet_mesh}[kind]
    ref_fn = {"pop": JMesh.make_pop_mesh, "fleet": JMesh.make_fleet_mesh}[kind]
    got = _outcome(lambda: port_fn(**kw, devices=["cpu"] * n))
    dev = jax.devices()[0]
    monkeypatch.setattr(jax, "devices", lambda *a: [dev] * n)
    want = _outcome(lambda: ref_fn(**kw))
    assert got == want


@pytest.mark.parametrize("n,data,model", [(1, 1, 1), (8, 2, 4), (8, 3, 4), (4, 8, 2), (16, 4, 4)])
def test_host_mesh_clamps_as_the_reference(monkeypatch, n, data, model):
    got = make_host_mesh(data, model, devices=["cpu"] * n)
    dev = jax.devices()[0]
    monkeypatch.setattr(jax, "devices", lambda *a: [dev] * n)
    # jax.make_mesh asks the backend itself; build its mesh over the patched list
    monkeypatch.setattr(jax, "make_mesh", lambda shape, axes: _jax_mesh(shape, axes))
    want = JMesh.make_host_mesh(data, model)
    assert got.axis_names == tuple(want.axis_names) == ("data", "model")
    assert got.shape == dict(want.shape)


def test_meshes_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (make_pop_mesh, make_fleet_mesh, make_host_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    mesh = make_fleet_mesh(2, 2, devices=["cpu"] * 4)
    assert mesh.shape == {"pop": 2, "model": 2} and list(mesh.shape) == ["pop", "model"]
    assert mesh.size == 4 and all(d == CPU for d in mesh.devices.flat)
    with pytest.raises(ValueError):
        Mesh(mesh.devices, ("pop",))


# ---------------------------------------------------------------------------
# the rules over every config's param specs
# ---------------------------------------------------------------------------

MESHES = {
    "4x4": ((4, 4), ("data", "model"), ()),
    "2x16": ((2, 16), ("data", "model"), ()),
    "2x2x4": ((2, 2, 4), ("pod", "data", "model"), ()),
    "pop4x2": ((4, 2), ("pop", "model"), ("pop",)),
}
FLAGS = {
    "fsdp-off": dict(fsdp=False),
    "fsdp-on": dict(fsdp=True),
    "seq": dict(fsdp=None, seq_shard=True, seq_rule=True),
    "moe-slots": dict(fsdp=True, moe_slot_shard=True),
}


@functools.cache
def _port_shapes(arch):
    """Every param's shape, by the port's names (a model on the meta
    device: nothing allocated)."""
    cfg = get_arch(arch)
    if cfg.family == "classifier":
        return {k: tuple(v.shape) for k, v in init_classifier(cfg, 0, 32, device="cpu").items()}
    return {k: tuple(v.shape) for k, v in Model(cfg, device="meta").named_parameters()}


def _ref_leaf(tree, name):
    """The reference's leaf for the port's name: convert.py's walk (a layer
    leaf ``layers.i.<path>`` is ``tree["layers"][<path>]``, stacked)."""
    parts = name.split(".")
    keys = ["layers", *parts[2:]] if parts[0] == "layers" else parts
    for k in keys:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_resolve_as_the_reference(arch, mesh, flags):
    shape, axes, reserved = MESHES[mesh]
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    ctx = make_rules_for_mesh(cfg, _mesh(shape, axes), reserved_axes=reserved, **FLAGS[flags])
    jctx = jax_rules(jcfg, _jax_mesh(shape, axes), reserved_axes=reserved, **FLAGS[flags])
    assert ctx.rules == jctx.rules and ctx.units == jctx.units
    shapes = _port_shapes(arch)
    if cfg.family == "classifier":
        specs, jspecs = classifier_param_axes(cfg), jax_classifier_param_axes(jcfg)
        assert specs == jspecs and set(specs) == set(shapes)
        for k, s in shapes.items():
            assert resolve_spec(specs[k], s, ctx) == tuple(jax_resolve(jspecs[k], s, jctx))
        return
    specs, jspecs = param_specs(cfg), JM.param_specs(jcfg)
    assert set(specs) == set(shapes)
    stacked = 0
    for name, s in shapes.items():
        jax_axes = _ref_leaf(jspecs, name)
        if name.startswith("layers."):
            # the reference stacks its layers: a leading "layers" axis, never split
            assert jax_axes[0] == "layers" and specs[name] == jax_axes[1:]
            want = tuple(jax_resolve(jax_axes, (cfg.num_layers,) + s, jctx))
            assert want[:1] in ((), (None,))
            want = want[1:]
            stacked += 1
        else:
            assert specs[name] == jax_axes
            want = tuple(jax_resolve(jax_axes, s, jctx))
        assert resolve_spec(specs[name], s, ctx) == want, name
    assert stacked == len(shapes) - len([k for k in shapes if not k.startswith("layers.")])


def test_opt_state_specs_mirror_the_state():
    specs = classifier_param_axes(MLP)
    params = init_classifier(MLP, 0, 32, device="cpu")
    ospecs = opt_state_specs(specs)
    assert ospecs == jax_opt_state_specs(jax_classifier_param_axes(jax_get_arch("paper-mlp")))
    state = adamw_init(params, AdamWConfig())
    assert set(ospecs) == set(state) and set(ospecs["m"]) == set(state["m"]) == set(ospecs["v"])
    ctx = make_rules_for_mesh(MLP, _mesh((4, 2), ("pop", "model")), fsdp=False, reserved_axes=("pop",))
    got = tree_specs(ospecs, state, ctx)
    assert got["count"] == () and got["m"]["w0"] == (None, "model") and got["v"]["b0"] == ("model",)
    with pytest.raises(ValueError, match="MeshContext"):
        tree_specs(ospecs, state)
    with mesh_context(ctx):
        assert current_mesh_context() is ctx
        assert tree_specs(ospecs, state) == got
    assert current_mesh_context() is None


# the reference's rules tests (tests/test_sharding.py), on the port's rules


def _ctx(arch, shape=(4, 4), axes=("data", "model"), **kw):
    return make_rules_for_mesh(get_arch(arch), _mesh(shape, axes), **kw)


def test_divisibility_fallback_heads():
    ctx = _ctx("smollm-135m")  # 9 heads, head_dim 64
    assert resolve_spec(("embed", "qkv"), (576, 9 * 64), ctx) == ()
    assert resolve_spec(("embed", "mlp"), (576, 1536), ctx) == (None, "model")


def test_heads_shard_when_divisible():
    ctx = _ctx("llama3-405b", fsdp=True)  # 128 heads
    assert resolve_spec(("embed", "qkv"), (16384, 128 * 128), ctx) == ("data", "model")
    assert resolve_spec(("embed", "kv"), (16384, 8 * 128), ctx) == ("data", "model")


def test_no_axis_used_twice():
    assert resolve_spec(("batch", "batch"), (8, 8), _ctx("qwen3-0.6b")) == ("data",)


def test_kv_cache_seq_fallback():
    ctx = _ctx("llama3-405b", (2, 16))  # kv=8 vs model=16
    spec = resolve_spec(("layers", "batch", "kv_heads", "kv_seq", None), (126, 128, 8, 32768, 128), ctx)
    assert spec == (None, "data", None, "model")


def test_expert_parallelism_when_divisible():
    ctx = _ctx("llama4-maverick-400b-a17b", (2, 16), fsdp=True)  # 128 experts
    assert resolve_spec(("expert", "embed", "mlp"), (128, 5120, 8192), ctx) == ("model", "data")
    ctx2 = _ctx("mixtral-8x22b", (2, 16), fsdp=True)  # 8 experts -> TP inside experts
    assert resolve_spec(("expert", "embed", "mlp"), (8, 6144, 16384), ctx2) == (None, "data", "model")


def test_multi_pod_batch_axes():
    ctx = _ctx("phi3-mini-3.8b", (2, 2, 4), ("pod", "data", "model"), fsdp=True)
    assert resolve_spec(("batch", "seq"), (256, 4096), ctx) == (("pod", "data"),)


def test_seq_carry_rule_only_when_enabled():
    on = _ctx("llama3-405b", fsdp=True, seq_shard=True)
    off = _ctx("llama3-405b", fsdp=True, seq_shard=False)
    assert resolve_spec(("batch", "seq_carry", "embed"), (256, 4096, 16384), on) == ("data", "model")
    assert resolve_spec(("batch", "seq_carry", "embed"), (256, 4096, 16384), off) == ("data",)


def test_fleet_mesh_rules_resolve_inside_pop_slice():
    ctx = _ctx("smollm-135m", (4, 2), ("pop", "model"), fsdp=False, reserved_axes=("pop",))
    assert ctx.reserved_axes == ("pop",)
    assert resolve_spec(("embed", "mlp"), (576, 1536), ctx) == (None, "model")
    assert resolve_spec(("batch", "embed"), (8, 576), ctx) == ()  # 'data' is absent
    ctx.rules["mlp"] = ("pop", "model")  # the reserved axis is skipped
    assert resolve_spec(("embed", "mlp"), (576, 1536), ctx) == (None, "model")
    ctx.rules["mlp"] = ("pop",)
    assert resolve_spec(("embed", "mlp"), (576, 1536), ctx) == ()


def test_classifier_axes_resolve_on_fleet_mesh():
    ctx = _ctx("paper-mlp", (4, 2), ("pop", "model"), fsdp=False, reserved_axes=("pop",))
    axes = classifier_param_axes(MLP)
    assert set(axes) == {f"{k}{i}" for k in "wb" for i in range(MLP.num_layers)}
    assert resolve_spec(axes["w0"], (32, MLP.d_ff), ctx) == (None, "model")
    assert resolve_spec(axes["b0"], (MLP.d_ff,), ctx) == ("model",)
    last = MLP.num_layers - 1
    assert resolve_spec(axes[f"w{last}"], (MLP.d_ff, MLP.vocab_size), ctx) == (None, "model")


def test_param_specs_refuse_the_classifier():
    with pytest.raises(NotImplementedError, match="classifier_param_axes"):
        param_specs(MLP)


# ---------------------------------------------------------------------------
# the engine's construction against the reference's sharded engine
# ---------------------------------------------------------------------------


def _loss(params, batch, ctx):
    return 0.0, {}


def _engines(shape, axes, population_size, **kw):
    """The port's and the reference's sharded engines on the same mesh
    (their run bodies never run here: the reference's need
    ``shard_map(auto=...)``, which jax 0.9 rejects; the port's are held to
    the vmap engine in test_torch_efat.py)."""
    port = ShardedPopulationEngine(
        mesh=_mesh(shape, axes), loss_fn=_loss, opt_cfg=AdamWConfig(), eval_batches=[],
        population_size=population_size, param_axes=classifier_param_axes(MLP), **kw)
    ref = JaxShardedPopulationEngine(
        mesh=_jax_mesh(shape, axes), loss_fn=_loss, opt_cfg=JaxAdamWConfig(), eval_batches=[{}],
        population_size=population_size, param_axes=jax_classifier_param_axes(jax_get_arch("paper-mlp")),
        **{k: (jax_get_arch("paper-mlp") if k == "cfg" else v) for k, v in kw.items()})
    return port, ref


@pytest.mark.parametrize("shape,axes", [((4,), ("pop",)), ((1,), ("pop",)), ((3,), ("pop",)),
                                        ((2, 2), ("pop", "model")), ((4, 2), ("pop", "model")),
                                        ((2, 4), ("model", "pop"))])
@pytest.mark.parametrize("population_size", [1, 3, 8, 16])
def test_engine_construction_matches_the_reference(shape, axes, population_size):
    port, ref = _engines(shape, axes, population_size, cfg=MLP)
    assert port.num_shards == ref.num_shards
    assert port.model_axes == ref.model_axes and port.model_size == ref.model_size
    assert port.population_size == ref.population_size
    for n in (1, 2, 5, 7, 16, 33):
        assert list(port._chunks(n)) == list(ref._chunks(n))
    assert FleetScheduler.for_engine(port).width_multiple == JaxFleetScheduler.for_engine(ref).width_multiple
    assert port.kind == ref.kind == "sharded" and port.last_fit_stats is None


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", ["no-pop-axis", "bad-compute", "no-rules", "no-param-axes"])
def test_engine_construction_raises_as_the_reference(case):
    base = dict(loss_fn=_loss, eval_batches=[], population_size=4)
    jcfg = jax_get_arch("paper-mlp")
    if case == "no-pop-axis":
        kws = (dict(mesh=_mesh((4,), ("rows",))), dict(mesh=_jax_mesh((4,), ("rows",))))
    elif case == "bad-compute":
        kws = (dict(mesh=_mesh((4,), ("pop",)), compute="bogus"), dict(mesh=_jax_mesh((4,), ("pop",)), compute="bogus"))
    elif case == "no-rules":
        kws = (dict(mesh=_mesh((2, 2), ("pop", "model")), param_axes=classifier_param_axes(MLP)),
               dict(mesh=_jax_mesh((2, 2), ("pop", "model")), param_axes=jax_classifier_param_axes(jcfg)))
    else:
        kws = (dict(mesh=_mesh((2, 2), ("pop", "model")), cfg=MLP),
               dict(mesh=_jax_mesh((2, 2), ("pop", "model")), cfg=jcfg))
    got = _error(lambda: ShardedPopulationEngine(opt_cfg=AdamWConfig(), **base, **kws[0]))
    want = _error(lambda: JaxShardedPopulationEngine(opt_cfg=JaxAdamWConfig(), **{**base, "eval_batches": [{}]},
                                                     **kws[1]))
    assert got is not None and got == want


def test_sharded_compute_and_the_default_mesh():
    """compute="sharded" constructs on a 2-D mesh with the reference's
    attributes; an unknown mode raises; without a mesh the engine takes the
    pop mesh its caller builds."""
    jcfg = jax_get_arch("paper-mlp")
    base = dict(loss_fn=_loss, population_size=6, compute="sharded")
    got = ShardedPopulationEngine(mesh=_mesh((2, 2), ("pop", "model")), cfg=MLP, param_axes=classifier_param_axes(MLP),
                                  opt_cfg=AdamWConfig(), eval_batches=[], **base)
    want = JaxShardedPopulationEngine(mesh=_jax_mesh((2, 2), ("pop", "model")), cfg=jcfg, eval_batches=[{}],
                                      param_axes=jax_classifier_param_axes(jcfg), opt_cfg=JaxAdamWConfig(), **base)
    for attr in ("compute", "model_size", "num_shards", "population_size", "axis_name", "model_axes"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.compute == "sharded" and got.model_size == 2
    with pytest.raises(ValueError, match="compute must be"):
        ShardedPopulationEngine(mesh=_mesh((2, 2), ("pop", "model")), cfg=MLP, compute="tensor",
                                param_axes=classifier_param_axes(MLP), loss_fn=None, opt_cfg=AdamWConfig(),
                                eval_batches=[])
    eng = make_fat_engine("sharded", mesh=make_pop_mesh(devices=["cpu"] * 4), loss_fn=None,
                          opt_cfg=AdamWConfig(), eval_batches=[])
    assert isinstance(eng, ShardedPopulationEngine) and eng.num_shards == 4 and eng.population_size == 16


# ---------------------------------------------------------------------------
# capacity planning on a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", [None, ((4,), ("pop",)), ((4, 2), ("pop", "model")), ((2, 2, 2), ("pop", "a", "b")),
                                  ((2,), ("model",))])
@pytest.mark.parametrize("arch,members", [("paper-mlp", 3), ("paper-mlp", 70), ("smollm-135m", 2)])
def test_suggest_population_size_on_a_mesh_matches_the_reference(mesh, arch, members):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    budget = cfg.param_count() * 12 * members
    port_mesh = None if mesh is None else _mesh(*mesh)
    jmesh = None if mesh is None else _jax_mesh(*mesh)
    want = jax_suggest(jcfg, jmesh, hbm_bytes=budget, headroom=1.0)
    assert suggest_population_size(cfg, port_mesh, hbm_bytes=budget, headroom=1.0) == want
    if mesh is None:
        assert suggest_population_size(cfg, hbm_bytes=budget, headroom=1.0) == want


def test_suggest_population_size_on_a_mesh_validates_like_the_reference():
    mesh_2d, jmesh_2d = _mesh((4, 2), ("pop", "model")), _jax_mesh((4, 2), ("pop", "model"))
    budget = MLP.param_count() * 12 * 3
    assert suggest_population_size(MLP, _mesh((4,), ("pop",)), hbm_bytes=budget, headroom=1.0) == 12
    assert suggest_population_size(MLP, mesh_2d, hbm_bytes=budget, headroom=1.0) == 24
    for fn in (lambda: suggest_population_size(get_arch("llama3-405b"), mesh_2d, hbm_bytes=budget),
               lambda: jax_suggest(jax_get_arch("llama3-405b"), jmesh_2d, hbm_bytes=budget)):
        with pytest.raises(ValueError, match="model axis"):
            fn()
    with pytest.raises(ValueError, match="headroom"):
        suggest_population_size(MLP, mesh_2d, hbm_bytes=budget, headroom=0.0)
    with pytest.raises(ValueError, match="no device memory figure"):
        suggest_population_size(MLP, mesh_2d)  # the CPU mesh's device has none
