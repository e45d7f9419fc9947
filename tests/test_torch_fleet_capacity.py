"""The port's fleet capacity planner and its ``launch/obs.py`` CLI against the
reference package.

``suggest_population_size`` at the same explicit budget (one device, model
extent 1) gives the reference's size, and four times it on a pop mesh of 4;
on the CPU without a budget it raises
(the port assumes no device size); the kernel reserve sums the tuning
cache's largest recorded shared-memory footprint per kernel, where the
reference sums VMEM. The CLI's ``--check``, ``--summary`` and ``--convert``
print the same JSON, write the same trace and exit with the same codes as
the reference's on the same logs, one of them with a fired alert. All
comparisons are exact: sizes are integers, and both CLIs read one file.
"""
import json

import pytest

from repro.configs import get_arch as jax_get_arch
from repro.fleet import suggest_population_size as jax_suggest
from repro.launch.obs import main as jax_obs_main
from repro.tune.cache import TuningCache as JaxTuningCache
from repro.tune.cache import cache_key as jax_cache_key
from repro_torch.configs import get_arch
from repro_torch.fleet import suggest_population_size
from repro_torch.fleet.capacity import device_memory_bytes, kernel_smem_reserve
from repro_torch.launch.mesh import make_pop_mesh
from repro_torch.launch.obs import main as obs_main
from repro_torch.obs import AlertEngine, AlertRule, Recorder, write_jsonl
from repro_torch.tune.cache import TuningCache, cache_key

ARCHS = ["smollm-135m", "hymba-1.5b", "falcon-mamba-7b", "paper-mlp"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("budget", [2 << 30, 16 << 30, 80 << 30])
@pytest.mark.parametrize("headroom", [0.6, 1.0])
def test_suggest_population_size_matches_reference(arch, budget, headroom):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    assert cfg.param_count() == jcfg.param_count()
    kw = dict(hbm_bytes=budget, headroom=headroom)
    try:
        want = jax_suggest(jcfg, **kw)
    except ValueError:
        with pytest.raises(ValueError, match="budget"):
            suggest_population_size(cfg, **kw)
        return
    assert suggest_population_size(cfg, **kw) == want
    assert suggest_population_size(cfg, make_pop_mesh(devices=["cpu"] * 4), **kw) == 4 * want


def test_suggest_population_size_validates_like_the_reference():
    cfg, jcfg = get_arch("smollm-135m"), jax_get_arch("smollm-135m")
    for kw in (dict(hbm_bytes=0), dict(hbm_bytes=1 << 30, headroom=0.0), dict(hbm_bytes=1 << 30, headroom=1.5)):
        with pytest.raises(ValueError):
            jax_suggest(jcfg, **kw)
        with pytest.raises(ValueError):
            suggest_population_size(cfg, **kw)
    assert suggest_population_size(cfg, hbm_bytes=80 << 30, max_members_per_lane=3) == 3


def test_no_budget_on_the_cpu_raises():
    """The reference falls back to a TPU's 16 GiB where its backend reports
    no limit; the port has no such number: on the CPU the caller passes it."""
    cfg = get_arch("smollm-135m")
    with pytest.raises(ValueError, match="hbm_bytes"):
        suggest_population_size(cfg, device="cpu")
    with pytest.raises(ValueError, match="hbm_bytes"):
        device_memory_bytes("cpu")


def _caches(tmp_path):
    """One tuning table written twice: the port's with ``smem_bytes``, the
    reference's with ``vmem_bytes``, the same numbers."""
    rows = [("decode_attention", dict(b=4, d=64), 40960), ("decode_attention", dict(b=8, d=64), 73728),
            ("flash_attention", dict(s=2048, d=64), 98304), ("masked_matmul", dict(m=4, k=576), 0)]
    port = {cache_key(k, s, "bfloat16", "cuda"): dict(blocks=dict(bkv=64), smem_bytes=b) for k, s, b in rows}
    ref = {jax_cache_key(k, s, "bfloat16", "tpu"): dict(blocks=dict(bkv=64), vmem_bytes=b) for k, s, b in rows}
    port["masked_matmul|k=1,m=1|float32|cuda"] = dict(blocks={}, smem_bytes="n/a")  # skipped, as the reference
    paths = []
    for name, entries in (("port.json", port), ("ref.json", ref)):
        p = tmp_path / name
        p.write_text(json.dumps(dict(version=1, entries=entries)))
        paths.append(str(p))
    return TuningCache.load(paths[0]), JaxTuningCache.load(paths[1])


def test_kernel_reserve_sums_each_kernels_largest_smem_footprint(tmp_path):
    port, ref = _caches(tmp_path)
    assert port.smem_footprints() == ref.vmem_footprints() == dict(
        decode_attention=73728, flash_attention=98304, masked_matmul=0)
    assert kernel_smem_reserve(port) == 73728 + 98304
    assert kernel_smem_reserve(TuningCache()) == 0
    cfg, jcfg = get_arch("paper-mlp"), jax_get_arch("paper-mlp")
    budget = 4 * cfg.param_count() * 12 + 100_000  # the reserve costs members
    want = jax_suggest(jcfg, hbm_bytes=budget, headroom=1.0, reserve_kernel_vmem=True, tuning_cache=ref)
    got = suggest_population_size(cfg, hbm_bytes=budget, headroom=1.0, reserve_kernel_smem=True,
                                  tuning_cache=port)
    assert got == want < suggest_population_size(cfg, hbm_bytes=budget, headroom=1.0)
    with pytest.raises(ValueError, match="reserve"):
        suggest_population_size(cfg, hbm_bytes=1000, reserve_kernel_smem=True, tuning_cache=port)


# ---------------------------------------------------------------------------
# launch/obs.py
# ---------------------------------------------------------------------------


def _logs(tmp_path):
    """A log of a serve-like run, and one in which an alert rule fired."""
    rec = Recorder(capacity=64)
    t0 = rec.now()
    rec.span("admit", proc="serve", track="slot0", t0=t0, t1=t0 + 0.01, args=dict(rid=0))
    rec.instant("retire", proc="serve", track="slot0", args=dict(rid=0))
    rec.sample("kv.free_pages", 7, proc="serve", track="pages")
    rec.count("serve.tokens_emitted", 3)
    rec.gauge_set("serve.compiles.total", 2)
    plain = tmp_path / "run.jsonl"
    write_jsonl(str(plain), rec)
    rec2 = Recorder()
    eng = AlertEngine(rec2, [AlertRule("hot", "temp", ">", 1.0)])
    rec2.gauge_set("temp", 5.0)
    eng.evaluate(clock=0)
    rec2.instant("fault.detected", proc="fleet", track="chip1/health", args=dict(chip=1, faults=3))
    alerted = tmp_path / "alerted.jsonl"
    write_jsonl(str(alerted), rec2)
    return plain, alerted


def _run(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def test_obs_cli_check_matches_reference(capsys):
    assert _run(obs_main, ["--check"], capsys) == _run(jax_obs_main, ["--check"], capsys)
    assert obs_main(["--check"]) == 0


@pytest.mark.parametrize("which", ["plain", "alerted"])
@pytest.mark.parametrize("check", [False, True])
def test_obs_cli_summary_matches_reference(tmp_path, capsys, which, check):
    plain, alerted = _logs(tmp_path)
    path = str(plain if which == "plain" else alerted)
    argv = ["--summary", path] + (["--check"] if check else [])
    got, want = _run(obs_main, argv, capsys), _run(jax_obs_main, argv, capsys)
    assert got[0] == want[0] == (1 if which == "alerted" and check else 0)
    assert got[2] == want[2]
    # --check prints its own line first; the summary is the JSON after it
    body = lambda out: json.loads(out[out.index("{"):])
    assert body(got[1]) == body(want[1])
    if which == "alerted":
        assert body(got[1])["alerts"]["fired"] == ["hot"]
        assert body(got[1])["fault_detections"][0]["chip"] == 1


def test_obs_cli_convert_matches_reference(tmp_path, capsys):
    _, alerted = _logs(tmp_path)
    out, jout = tmp_path / "port.trace.json", tmp_path / "ref.trace.json"
    rc, _, err = _run(obs_main, ["--convert", str(alerted), "--trace-out", str(out)], capsys)
    jrc, _, jerr = _run(jax_obs_main, ["--convert", str(alerted), "--trace-out", str(jout)], capsys)
    assert rc == jrc == 0 and err == jerr
    assert json.loads(out.read_text()) == json.loads(jout.read_text())
    with pytest.raises(SystemExit):
        obs_main(["--convert", str(alerted)])  # needs --trace-out
    with pytest.raises(SystemExit):
        obs_main([])
