"""The port's program analyses against the reference's ``repro.analysis``.

Golden cases: each pass fires its code on a deliberately broken program and
stays silent on the fixed one (DON001 on a planted rebind and its in-place
twin; RCP001/RCP002 on a length-keyed program and its bucketed twin;
SHD001/SHD002 and their clean cases, the port's layer grouping too). The
recompile census is held to the program keys a real engine records. The
shipped stack: for every architecture the reference lints, the cheap passes
give the reference's keys and the refused ones raise in both packages; the
full report, donation included, on the CPU has only keys of the committed
baseline; and the CLI gates on it. Nothing here needs a card.
"""
import json

import numpy as np
import pytest
import torch

from repro.analysis import analyze_stack as jax_analyze_stack
from repro.configs import list_archs as jax_list_archs
from repro_torch.analysis import (
    EntryTraceModel,
    FakeMesh,
    ProgramSpec,
    ShardingEntry,
    analyze_stack,
    build_stack,
    default_baseline_path,
    lint_donation,
    lint_recompile,
    lint_sharding,
    load_baseline,
    synthetic_trace,
)
from repro_torch.analysis.findings import Finding, Report
from repro_torch.analysis.recompile import census
from repro_torch.analysis.tree import subject
from repro_torch.configs import get_arch, list_archs, reduce_config
from repro_torch.launch import analyze as analyze_cli
from repro_torch.launch.sharding import MeshContext
from repro_torch.models import model as M

REFUSED = ("falcon_mamba_7b", "hubert_xlarge", "hymba_1_5b")
INTERNVL2_KEYS = {"SHD001:fleet.params:embed", "SHD001:fleet.params:lm_head"}
CHEAP = ("recompile", "sharding", "kernels")


def _codes(findings):
    return [f.code for f in findings]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the finding model
# ---------------------------------------------------------------------------


def test_finding_round_trips_and_checks_severity():
    f = Finding("DON001", "e", "s", "m", severity="warn", bytes=12.0)
    assert f.key == "DON001:e:s"
    assert Finding.from_dict(f.as_dict()) == f
    with pytest.raises(ValueError):
        Finding("DON001", "e", "s", "m", severity="fatal")


def test_report_against_a_baseline(tmp_path):
    r = Report(meta=dict(arch="x"))
    r.extend([Finding("A", "e", "1", "m", bytes=1.0), Finding("B", "e", "2", "m", severity="warn", bytes=9.0)])
    assert [f.code for f in r.sorted_findings()] == ["A", "B"]  # errors first
    assert [f.key for f in r.new_vs_baseline({"A:e:1"})] == ["B:e:2"]
    assert r.resolved_vs_baseline({"A:e:1", "C:e:3"}) == ["C:e:3"]
    path = tmp_path / "report.json"
    r.save(str(path))
    assert load_baseline(str(path)) == r.keys()
    (tmp_path / "base.json").write_text(json.dumps(r.baseline_dict()))
    assert load_baseline(str(tmp_path / "base.json")) == {"A:e:1", "B:e:2"}


@pytest.mark.parametrize("path,want", [
    (("layers.3.attn.wq",), "layers/attn/wq"),
    (("m", "layers.12.mlp.wd"), "m/layers/mlp/wd"),
    (("final_ln.scale",), "final_ln/scale"),
    (("cache", "k_pages"), "cache/k_pages"),
    ((), "value"),
])
def test_subject_groups_layer_copies(path, want):
    assert subject(path) == want


# ---------------------------------------------------------------------------
# donation pass (DON001)
# ---------------------------------------------------------------------------


def _loop_spec(*, in_place: bool) -> ProgramSpec:
    """A tiny serve-loop shape: a big carried buffer + a small accumulator."""
    if in_place:
        def fn(buf, acc):
            return buf.add_(1.0), acc + buf.sum()
    else:
        def fn(buf, acc):
            return buf + 1.0, acc + buf.sum()
    return ProgramSpec(
        name="golden.loop",
        fn=fn,
        args=(torch.zeros((256, 256)), torch.zeros(())),
        carried=frozenset({0}),
        arg_names=("buf", "acc"),
        returns={0: 0},
    )


@pytest.mark.parametrize("in_place", [False, True], ids=["planted-rebind", "in-place"])
def test_donation_golden(in_place):
    findings, stats = lint_donation(_loop_spec(in_place=in_place))
    if in_place:
        assert findings == []
        assert stats["donated_fraction"] == 1.0
        assert stats["subjects"] == {"buf": "kept"}
    else:
        assert _codes(findings) == ["DON001"]
        assert findings[0].subject == "buf"
        assert findings[0].bytes == 256 * 256 * 4
        assert stats["donated_fraction"] < 1.0
        assert stats["subjects"] == {"buf": "rebound"}
    assert stats["carried_bytes"] == 256 * 256 * 4


def test_donation_groups_layers_and_reads_engine_state():
    """A state object read back after the call, with unrolled layers: one
    subject per layer leaf, rebound if any layer came back new; a reused
    argument written in place is not intact."""
    state = {"layers.0.w": torch.zeros(64, 64), "layers.1.w": torch.zeros(64, 64), "b": torch.zeros(4)}
    params0 = torch.ones(8)

    def step(st, p0):
        st["layers.0.w"].add_(1.0)
        st["layers.1.w"] = st["layers.1.w"] + 1.0
        p0.mul_(2.0)

    spec = ProgramSpec(name="golden.state", fn=step, args=(state, params0), carried=frozenset({0}),
                       arg_names=("state", "params0"), reused=frozenset({1}))
    findings, stats = lint_donation(spec, min_bytes=1 << 14)
    assert stats["subjects"] == {"state/layers/w": "rebound", "state/b": "kept"}
    assert [f.key for f in findings] == ["DON001:golden.state:state/layers/w"]
    assert findings[0].bytes == 64 * 64 * 4  # only the rebound layer's bytes
    assert stats["reused_intact"] is False


def test_serve_engine_sample_decode_writes_its_cache_in_place():
    """The shipped sample-decode keeps its cache's storage; a step that
    returns a copied cache (the planted regression) is flagged."""
    cfg = reduce_config(get_arch("smollm-135m"))
    progs = build_stack("smollm-135m", device="cpu")
    spec = next(s for s in progs.donation_specs if s.name == "serve.sample_decode")
    findings, stats = lint_donation(spec, min_bytes=1 << 14)
    assert findings == []
    assert stats["subjects"]["cache/k"] == stats["subjects"]["cache/v"] == "kept"

    def copying(*args):
        nxt, lp, cur, cache = spec.fn(*args)
        return nxt, lp, cur, {k: v.clone() if torch.is_tensor(v) else v for k, v in cache.items()}

    fresh = build_stack("smollm-135m", device="cpu").donation_specs[0]
    planted = ProgramSpec(name="planted.sample_decode", fn=copying, args=fresh.args, carried=fresh.carried,
                          arg_names=fresh.arg_names, returns=fresh.returns)
    f_pre, s_pre = lint_donation(planted, min_bytes=1 << 14)
    cache_bytes = 2 * M.init_cache(cfg, 2, 64, device="cpu")["k"].nbytes
    assert sorted(f.subject for f in f_pre) == ["cache/k", "cache/v"]
    assert s_pre["undonated_carried_bytes"] - stats["undonated_carried_bytes"] == cache_bytes


# ---------------------------------------------------------------------------
# recompile pass (RCP001/RCP002)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bucketed", [False, True], ids=["raw-length", "bucketed"])
def test_recompile_golden(bucketed):
    if bucketed:
        model = EntryTraceModel("golden.bucketed_prefill", lambda r: ("prefill", 64 * -(-r.prompt_len // 64)),
                                dims=("prompt_len",))
    else:
        model = EntryTraceModel("golden.raw_prefill", lambda r: ("prefill", r.prompt_len), dims=("prompt_len",))
    findings, stats = lint_recompile([model], synthetic_trace())
    if bucketed:
        assert findings == []
        assert stats["golden.bucketed_prefill"]["sweep_prompt_len"] < 12
    else:
        assert "RCP001" in _codes(findings)
        assert findings[0].subject == "prompt_len"
        # the mixed-length trace alone also blows the signature budget
        assert "RCP002" in _codes(findings)


def _trace_model(name):
    return next(m for m in build_stack("smollm-135m").trace_models if m.name == name)


def test_census_equals_the_continuous_engines_program_keys():
    """The counterpart of the reference's jit-cache check: the census of the
    continuous entries over a trace is the set of program keys a reduced
    engine serving those requests runs (one request a pack, as the census
    models a request alone)."""
    from repro_torch.serve.continuous import ContinuousBatchingEngine, Request

    cfg = reduce_config(get_arch("smollm-135m"))
    params = M.init_params(cfg, 0, device="cpu")
    eng = ContinuousBatchingEngine(cfg, params, num_slots=4, page_size=8, num_pages=256,
                                   max_pages_per_seq=64, max_pack=1)
    trace = synthetic_trace()
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(1, cfg.vocab_size, r.prompt_len), r.max_new_tokens)
            for i, r in enumerate(trace)]
    eng.serve(reqs)
    sigs = set()
    for name in ("continuous.sample_decode", "continuous.prefill_admit"):
        model = _trace_model(name)
        sigs |= {model.signature_of(r) for r in trace}
        assert census(model, trace)["signatures"] == len({model.signature_of(r) for r in trace})
    assert sigs == eng.used_programs


def test_census_equals_the_serve_engines_prefill_widths(monkeypatch):
    from repro_torch.serve.engine import ServeEngine

    cfg = reduce_config(get_arch("smollm-135m"))
    params = M.init_params(cfg, 0, device="cpu")
    widths = set()
    prefill = M.prefill

    def recording(p, batch, *a, **kw):
        widths.add(batch["tokens"].shape[1])
        return prefill(p, batch, *a, **kw)

    monkeypatch.setattr(M, "prefill", recording)
    eng = ServeEngine(cfg, params)
    trace = synthetic_trace()
    rng = np.random.default_rng(0)
    for r in trace:
        prompt = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, r.prompt_len)))
        eng.generate(prompt, max_new_tokens=r.max_new_tokens)
    model = _trace_model("serve.prefill")
    assert {model.signature_of(r)[1] for r in trace} == widths
    assert census(model, trace)["signatures"] == len(widths)


# ---------------------------------------------------------------------------
# sharding pass (SHD001/SHD002)
# ---------------------------------------------------------------------------


def _entry(rules, axes_leaf, shape, *, reserved=(), engine_axes=(), units=None):
    mctx = MeshContext(mesh=FakeMesh.of(pop=2, model=4), rules=rules, units=units or {},
                       reserved_axes=reserved)
    return ShardingEntry(name="golden.shard", mctx=mctx, axes={"w": axes_leaf},
                         structs={"w": torch.empty(shape, device="meta")}, engine_axes=engine_axes)


@pytest.mark.parametrize("case,want", [
    # "model"=4 is live for "qkv", but 1002 % 4 != 0: 4 MiB silently replicated
    (dict(rules={"qkv": ("model",)}, axes_leaf=("embed", "qkv"), shape=(1024, 1002)), ["SHD001"]),
    # no rule at all for the leaf's axes: replication by design
    (dict(rules={}, axes_leaf=("embed", "qkv"), shape=(1024, 1002)), []),
    # below the size threshold
    (dict(rules={"qkv": ("model",)}, axes_leaf=("embed", "qkv"), shape=(16, 10)), []),
    # a rule that grabs the fleet's "pop" axis inside a pop slice
    (dict(rules={"member": ("pop",)}, axes_leaf=("member", None), shape=(8, 4), engine_axes=("pop",)),
     ["SHD002"]),
    # the same, with "pop" reserved as the fleet builds its context
    (dict(rules={"member": ("pop",)}, axes_leaf=("member", None), shape=(8, 4), reserved=("pop",),
          engine_axes=("pop",)), []),
], ids=["lost-replication", "by-design", "below-threshold", "engine-owned", "reserved"])
def test_sharding_golden(case, want):
    findings, stats = lint_sharding([_entry(**case)])
    assert _codes(findings) == want
    if want == ["SHD001"]:
        assert findings[0].subject == "w"
        assert stats["golden.shard"]["replicated"] == 1


def test_sharding_groups_layer_leaves():
    """Two layers of 0.6 MiB each: under the threshold alone, over it as the
    one subject the reference stacks; layers that resolve differently raise."""
    mctx = MeshContext(mesh=FakeMesh.of(model=4), rules={"qkv": ("model",)})
    axes = {f"layers.{i}.attn.wq": ("embed", "qkv") for i in range(2)}
    structs = {k: torch.empty((512, 301), device="meta") for k in axes}
    findings, stats = lint_sharding([ShardingEntry("g", mctx, axes, structs)])
    assert [f.key for f in findings] == ["SHD001:g:layers/attn/wq"]
    assert findings[0].bytes == 2 * 512 * 301 * 4
    assert stats["g"]["leaves"] == 1
    structs["layers.1.attn.wq"] = torch.empty((512, 300), device="meta")
    with pytest.raises(ValueError, match="resolve differently"):
        lint_sharding([ShardingEntry("g", mctx, axes, structs)])


# ---------------------------------------------------------------------------
# the shipped stack, against the reference's, and the baseline
# ---------------------------------------------------------------------------


def test_the_packages_lint_the_same_architectures():
    assert list_archs() == jax_list_archs()


@pytest.mark.parametrize("arch", list_archs())
def test_cheap_passes_match_the_reference(arch):
    if arch in REFUSED:
        with pytest.raises(ValueError):
            jax_analyze_stack(arch, passes=CHEAP)
        with pytest.raises(ValueError):
            analyze_stack(arch, passes=CHEAP)
        return
    want = jax_analyze_stack(arch, passes=CHEAP).keys()
    got = analyze_stack(arch, passes=CHEAP)
    assert got.keys() == want
    assert not [k for k in got.keys() if k.startswith(("RCP", "KRN"))]
    assert set(got.passes) == set(CHEAP)
    # the committed baseline covers every linted architecture's cheap passes
    assert got.new_vs_baseline(load_baseline(default_baseline_path())) == []


@pytest.fixture(scope="module")
def full_report():
    return analyze_stack("smollm-135m", device="cpu")


def test_full_report_has_only_baselined_keys(full_report):
    """smollm's full report is the baseline, but for internvl2-26b's two
    SHD001 keys (its vocabulary splits over no mesh axis), which the
    baseline also holds so that every linted architecture checks clean."""
    baseline = load_baseline(default_baseline_path())
    new = full_report.new_vs_baseline(baseline)
    assert new == [], [f.key for f in new]
    assert full_report.resolved_vs_baseline(baseline) == sorted(INTERNVL2_KEYS)


def test_donation_classifies_every_carried_subject(full_report):
    """The reduced run's classification, which the card run at full width
    is held to: the continuous decode rebinds its slot state's small
    tensors and the page tables' lengths; every other serving leaf keeps its
    storage; the train step rebinds every param and moment; the population
    sweep carries nothing and leaves params0 as it found it."""
    entries = full_report.passes["donation"]["entries"]
    rebound = {name: sorted(s for s, c in e["subjects"].items() if c == "rebound") for name, e in entries.items()}
    assert rebound["serve.sample_decode"] == ["cur_logits"]
    assert rebound["serve.decode"] == []
    assert rebound["continuous.sample_decode"] == [
        "state/active", "state/cache/seq_lens", "state/cur", "state/remaining"]
    assert rebound["continuous.prefill_admit"] == rebound["continuous.prefill_chunk"] == []
    assert entries["train.step"]["donated_bytes"] == 0
    assert set(entries["train.step"]["subjects"]) == set(rebound["train.step"])
    assert entries["population.fit_run"]["carried_bytes"] == 0
    assert entries["population.fit_run"]["reused_intact"] is True
    keys = {f.key for f in full_report.findings if f.code == "DON001"}
    assert keys and all(k.startswith("DON001:train.step:") for k in keys)


def test_analyze_cli_check_passes_on_the_committed_baseline(tmp_path):
    assert analyze_cli.main(["--check", "--device", "cpu", "--out", str(tmp_path / "r.json")]) == 0
    report = json.loads((tmp_path / "r.json").read_text())
    keys = {Finding.from_dict(f).key for f in report["findings"]}
    assert keys == load_baseline(default_baseline_path()) - INTERNVL2_KEYS


def test_analyze_cli_check_fails_on_a_finding_the_baseline_lacks(tmp_path):
    keys = sorted(load_baseline(default_baseline_path()))
    dropped = "SHD001:train.params:layers/attn/wq"
    assert dropped in keys
    base = tmp_path / "base.json"
    base.write_text(json.dumps(dict(keys=[k for k in keys if k != dropped])))
    argv = ["--check", "--passes", "recompile,sharding,kernels", "--baseline", str(base),
            "--out", str(tmp_path / "r.json")]
    assert analyze_cli.main(argv) == 1


def test_analyze_cli_raises_without_a_card_or_a_device(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        analyze_cli.main(["--check", "--out", str(tmp_path / "r.json")])
