#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--profile]

Phases; any failure ends the run with a nonzero exit and no result line:

1. the card's name and power limit, and the build of every kernel from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, started together);
2. kernel parity: the masked GEMM and flash attention against their plain
   PyTorch versions at the shapes of the serving path, with their times on
   the card beside the bound, the plain version and one library call. The
   layer GEMMs run at M = 4 (decode and the prefill unembed), 512 (serving
   prefill, 4 x 128), 1024 and 8192 (long prefill, 4 x 2048); the tied
   unembed at M = 4 and 1024;
3. serve: SmolLM-135M at full published width (random weights, seed 0) on
   a 256x256 array with 10% of its PEs faulty, through ``ServeEngine`` in
   ``kernel`` mode: 4 prompts of 128 tokens, 32 greedy new tokens, in bf16
   and in float32. The served sequences are re-run teacher-forced through
   the plain ``fap`` context and the logits are gated;
4. long prefill: ``prefill`` at 4 x 2048 tokens in ``kernel`` mode with the
   flash kernel, against the plain path (``fap`` context, dense attention):
   logits and KV cache;
5. a ``{"kernels": [...]}`` line, the card's line, and last the
   ``{"ok": true, "device": ...}`` line.

``--profile`` adds a phase after 3: the bf16 engine serves 8 new tokens
once untraced (wall time) and once under ``torch.profiler`` tracing the
card alone; device time by kernel goes to ``build/profile_serve.txt``, and
the busy share is the traced kernel time over the untraced wall time.

Launch counts are set to 0 just before each main-path run (phases 3 and 4)
and read just after it; the parity and timing launches of phase 2 are not
counted. Tolerances, each printed beside its error:

- the masked GEMM against its plain version: the repository's per-dtype
  table (``dtype_tol``: bf16 rtol 2e-2 / atol 2e-1, float32 rtol 2e-5 /
  atol 2e-4). Its bf16 outputs have an RMS of about 1, so atol 0.2 is one
  part in five of a typical element;
- flash attention in bf16: rtol 2e-2 / atol 1e-2. Its outputs at S=2048
  have an RMS of only 0.05-0.1, where the table's atol 0.2 would pass
  almost anything; the kernel's measured bf16 error is 2e-3-4e-3. float32
  takes the table;
- whole-model logits and KV caches: bf16 takes the table elementwise and,
  in phase 4, a relative L2 error (||got - ref|| / ||ref||) of at most
  5e-2; float32 takes atol 1e-3 (``atol_scale=50``) because 30 layers of
  reassociated fp32 sums compound.

Plain-version float32 matmuls run without TF32 (``allow_tf32=False``), so
they are true fp32.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor / fp32 non-tensor
BATCH, PROMPT, NEW, LONG = 4, 128, 32, 2048
FLASH_BF16_TOL = (2e-2, 1e-2)  # (rtol, atol); see the module docstring
MAX_REL_L2 = 5e-2


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one bf16 serving run (build/profile_serve.txt)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script runs on a CUDA card")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        return fail(f"no src/repro_torch beside {Path(__file__).name}: run it from the repository")
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.configs import get_arch
    from repro_torch.core import from_fault_map, random_fault_map
    from repro_torch.kernels.common import build_kernels, dtype_tol
    from repro_torch.kernels.flash_attention.ops import attention_ref, flash_attention
    from repro_torch.kernels.masked_matmul.ops import masked_matmul, masked_matmul_ref
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        "plain fp32 matmuls without TF32")

    # ---- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    logs = build_kernels(["masked_matmul", "flash_attention"])
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs) or 'cached'}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 1 GiB: overwriting it evicts the 50 MB L2 and keeps the card busy for about
    # 0.3 ms, longer than the host takes to enqueue the timed launch, so the
    # events below time the device alone
    flush = torch.empty(2**28, dtype=torch.int32, device=dev)

    def time_ms(fn, reps=10):
        """Median of single launches timed by CUDA events, each with the L2
        cache overwritten first, as a serving step finds it."""
        fn()
        times = []
        for _ in range(reps):
            flush.zero_()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)

    def worst(got, ref, tol):
        """(max abs error, whether every element is within tol = (rtol, atol))."""
        rtol, atol = tol
        diff = (got.float() - ref.float()).abs()
        return float(diff.max()), bool((diff <= atol + rtol * ref.float().abs()).all())

    def rel_l2(got, ref):
        return float((got.float() - ref.float()).norm() / ref.float().norm())

    failures = []
    cfg = get_arch("smollm-135m")
    gen = torch.Generator(device=dev).manual_seed(0)

    # ---- phase 2: kernel parity -------------------------------------------
    oks = {
        rate: from_fault_map(random_fault_map(0, 256, 256, rate), "kernel", device=dev).ok
        for rate in (0.0, 0.1, 0.3)
    }
    mm_err, mm_rows = 0.0, {}
    for dtype in (torch.bfloat16, torch.float32):
        for idx, (k, n, uses) in enumerate(cfg.gemm_shapes()):
            tied = n == cfg.vocab_size  # the unembed reads embed.T, a strided view
            w32 = torch.randn(n, k, generator=gen, device=dev).T if tied else \
                torch.randn(k, n, generator=gen, device=dev)
            w32 = w32 / math.sqrt(k)
            w = w32.to(dtype)  # fault_linear's cast; keeps embed.T's strides
            if tied and w.stride(0) != 1:
                return fail(f"the unembed weight lost its transposed strides: {w.stride()}")
            # serving prefill gives the layers M = 4 x 128 and the long prefill
            # 4 x 2048; the unembed sees only the last position at prefill
            for m in (BATCH, 1024) if tied else (BATCH, BATCH * PROMPT, 1024, BATCH * LONG):
                x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
                err = 0.0
                for rate, ok in oks.items():
                    e, good = worst(masked_matmul(x, w, ok), masked_matmul_ref(x, w, ok), dtype_tol(dtype))
                    err, mm_err = max(err, e), max(mm_err, e)
                    if not good:
                        failures.append(f"masked_matmul {dtype} {m}x{k}x{n} rate {rate}: {err}")
                ok = oks[0.1]
                wm = w * (ok[torch.arange(k, device=dev) % 256][:, torch.arange(n, device=dev) % 256]).to(dtype)
                size = torch.finfo(dtype).bits // 8
                nbytes = (m * k + k * n + m * n) * size + ok.numel() * 4
                bound = max(nbytes / HBM_BYTES_PER_S, 2 * m * k * n / PEAK_OPS[str(dtype)[6:]]) * 1e3
                row = dict(
                    ms=time_ms(lambda: masked_matmul(x, w, ok)),
                    plain_ms=time_ms(lambda: masked_matmul_ref(x, w, ok), reps=5),
                    library_ms=time_ms(lambda: torch.matmul(x, wm)),
                    bound_ms=bound,
                    cast_ms=time_ms(lambda: w32.to(dtype)) if dtype == torch.bfloat16 else 0.0,
                    uses=uses, k=k, n=n, tied=tied,
                )
                mm_rows[(str(dtype)[6:], m, idx)] = row
                log(f"masked_matmul {str(dtype)[6:]:8s} M={m:5d} K={k:5d} N={n:6d}"
                    f"{' (embed.T)' if tied else ''}: err<= {err:.3g} (rtol, atol {dtype_tol(dtype)}) "
                    f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
                    f"torch.matmul(masked w) {row['library_ms']:.4f} ms  bound {bound:.4f} ms"
                    f"{'  cast fp32->bf16 %.4f ms' % row['cast_ms'] if row['cast_ms'] else ''}")

    fa_err, fa_rows = 0.0, {}
    b, hq, hkv, d = BATCH, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    for dtype in (torch.bfloat16, torch.float32):
        for s in (128, LONG):
            for case, window, sq in (("causal", None, s), ("window256", 256, s), ("q_offset", None, s // 2)):
                off = s - sq
                q = torch.randn(b, hq, sq, d, generator=gen, device=dev).to(dtype)
                kk = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(dtype)
                vv = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(dtype)
                kw = dict(causal=True, window=window, q_offset=off)
                tol = FLASH_BF16_TOL if dtype == torch.bfloat16 else dtype_tol(dtype)
                err, good = worst(flash_attention(q, kk, vv, **kw), attention_ref(q, kk, vv, **kw), tol)
                fa_err = max(fa_err, err)
                if not good:
                    failures.append(f"flash_attention {dtype} S={s} {case}: {err}")
                rows = torch.arange(sq, device=dev)[:, None] + off
                cols = torch.arange(s, device=dev)[None, :]
                keep = cols <= rows
                if window:
                    keep &= cols > rows - window
                pairs = int(keep.sum())
                size = torch.finfo(dtype).bits // 8
                nbytes = (2 * b * hq * sq * d + 2 * b * hkv * s * d) * size
                bound = max(nbytes / HBM_BYTES_PER_S, 4 * b * hq * d * pairs / PEAK_OPS[str(dtype)[6:]]) * 1e3
                kr, vr = kk.repeat_interleave(hq // hkv, 1), vv.repeat_interleave(hq // hkv, 1)
                sdpa = torch.nn.functional.scaled_dot_product_attention
                row = dict(
                    ms=time_ms(lambda: flash_attention(q, kk, vv, **kw)),
                    plain_ms=time_ms(lambda: attention_ref(q, kk, vv, **kw), reps=3),
                    library_ms=time_ms(lambda: sdpa(q, kr, vr, attn_mask=keep)),
                    bound_ms=bound,
                )
                fa_rows[(str(dtype)[6:], s, case)] = row
                log(f"flash_attention {str(dtype)[6:]:8s} B={b} Hq={hq} Hkv={hkv} Sq={sq:5d} "
                    f"Skv={s:5d} {case:9s}: err<= {err:.3g} (rtol, atol {tol}) kernel {row['ms']:.4f} ms  "
                    f"plain {row['plain_ms']:.4f} ms  sdpa {row['library_ms']:.4f} ms  "
                    f"bound {bound:.4f} ms")
    if failures:
        return fail("kernel parity: " + "; ".join(failures))

    # ---- phase 3: serve SmolLM-135M at full width on a 10%-faulty chip ----
    def reset():
        masked_matmul.launches = 0
        flash_attention.launches = 0

    params = M.init_params(cfg, 0, device=dev)
    fm = random_fault_map(0, cfg.array_rows, cfg.array_cols, 0.1)
    ctx_k = from_fault_map(fm, "kernel", device=dev)
    ctx_f = from_fault_map(fm, "fap", device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=dev)
    per_step = sum(uses for _, _, uses in cfg.gemm_shapes())
    launches = {"masked_matmul": 0, "flash_attention": 0}
    serve_report, engines = {}, {}
    for dtype, atol_scale in (("bfloat16", 10.0), ("float32", 50.0)):
        c = dataclasses.replace(cfg, dtype=dtype)
        eng = engines[dtype] = ServeEngine(c, params, ctx_k, max_len=None)
        eng.generate(prompts, max_new_tokens=2)  # warm-up, not counted
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        out = eng.generate(prompts, max_new_tokens=NEW)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = (masked_matmul.launches, flash_attention.launches)
        launches["masked_matmul"] += counts[0]
        if counts[0] != per_step * (1 + NEW) or counts[1] != 0:
            return fail(f"serve {dtype}: launches {counts}, expected {per_step} per step x {1 + NEW}")
        t1 = time.perf_counter()
        cache_len = eng.cache_len_for(PROMPT, NEW)
        M.prefill(params, {"tokens": prompts}, c, ctx_k, cache_len=cache_len, valid_len=PROMPT)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t1) * 1e3
        with torch.no_grad():
            seq = out.tokens
            ref = M.forward(params, {"tokens": seq[:, :-1]}, c, ctx_f, attn_impl="dense")
            got = M.forward(params, {"tokens": seq[:, :-1]}, c, ctx_k, attn_impl="dense")
        steps = slice(PROMPT - 1, PROMPT - 1 + NEW)
        ref_lp = torch.log_softmax(ref[:, steps].float(), -1).gather(-1, seq[:, PROMPT:, None])[..., 0]
        rtol, atol = dtype_tol(getattr(torch, dtype), atol_scale=atol_scale)
        lp_err = float((out.logprobs - ref_lp).abs().max())
        logit_diff = (got[:, steps].float() - ref[:, steps].float()).abs()
        logit_err = float(logit_diff.max())
        agree = float((ref[:, steps].argmax(-1) == seq[:, PROMPT:]).float().mean())
        serve_report[dtype] = dict(
            tokens_per_s=BATCH * NEW / dt, generate_s=dt, prefill_ms=prefill_ms,
            masked_matmul_launches=counts[0], launches_per_step=counts[0] / (1 + NEW),
            logprob_err=lp_err, logit_err=logit_err, token_agreement=agree,
        )
        log(f"serve {dtype}: {BATCH}x{NEW} tokens in {dt:.3f} s ({BATCH * NEW / dt:.1f} tok/s); "
            f"prefill {BATCH}x{PROMPT} {prefill_ms:.2f} ms; masked_matmul launches {counts[0]} "
            f"({counts[0] / (1 + NEW):.0f} per step), flash {counts[1]}; teacher-forced fap: "
            f"logprob err {lp_err:.3g}, logit err {logit_err:.3g} (rtol {rtol}, atol {atol}), "
            f"greedy token agreement {agree:.4f}")
        if lp_err > atol or not bool((logit_diff <= atol + rtol * ref[:, steps].float().abs()).all()):
            return fail(f"serve {dtype}: served logits disagree with the plain fap path")
        if not torch.isfinite(out.logprobs).all() or out.tokens.shape != (BATCH, PROMPT + NEW):
            return fail(f"serve {dtype}: bad output {tuple(out.tokens.shape)}")

    # ---- optional: where one bf16 serving run's device time goes ------------
    profile_report = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        eng, prof_new = engines["bfloat16"], 8
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=prof_new)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng.generate(prompts, max_new_tokens=prof_new)
            torch.cuda.synchronize()
        by_kernel = sorted(
            ((e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
             if e.self_device_time_total > 0),
            key=lambda r: -r[2],
        )
        busy_ms = sum(t for _, _, t in by_kernel)
        if not busy_ms:
            return fail("profile: torch.profiler recorded no device time")
        profile_report = dict(new_tokens=prof_new, wall_ms=wall_ms, busy_ms=busy_ms, busy_share=busy_ms / wall_ms)
        lines = [
            f"card: {card}; bf16 kernel mode; {BATCH}x{PROMPT} prompt, {prof_new} new tokens",
            f"untraced wall {wall_ms:.2f} ms; traced device time {busy_ms:.2f} ms "
            f"(busy {busy_ms / wall_ms:.1%} of the untraced wall)",
            f"{'device ms':>10} {'share':>7} {'calls':>7}  kernel",
        ] + [f"{t:10.3f} {t / busy_ms:7.1%} {n:7d}  {key[:110]}" for key, n, t in by_kernel[:25]]
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        (OUT_DIR / "profile_serve.txt").write_text("\n".join(lines) + "\n")
        for line in lines[1:12]:
            log(f"profile: {line}")

    # ---- phase 4: long prefill through the flash kernel --------------------
    long_tokens = torch.randint(0, cfg.vocab_size, (BATCH, LONG), generator=gen, device=dev)
    M.prefill(params, {"tokens": long_tokens[:, :256]}, cfg, ctx_k, attn_impl="kernel")
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    lk, ck = M.prefill(params, {"tokens": long_tokens}, cfg, ctx_k, attn_impl="kernel")
    torch.cuda.synchronize()
    kernel_prefill_ms = (time.perf_counter() - t0) * 1e3
    counts = (masked_matmul.launches, flash_attention.launches)
    launches["masked_matmul"] += counts[0]
    launches["flash_attention"] += counts[1]
    if counts != (per_step, cfg.num_layers):
        return fail(f"long prefill: launches {counts}, expected ({per_step}, {cfg.num_layers})")
    # the plain path: masked weights by the fap context, dense attention
    t0 = time.perf_counter()
    ld, cd = M.prefill(params, {"tokens": long_tokens}, cfg, ctx_f, attn_impl="dense")
    torch.cuda.synchronize()
    plain_prefill_ms = (time.perf_counter() - t0) * 1e3
    long_err = {}
    for name, a, r in (("logits", lk, ld), ("k", ck["k"], cd["k"]), ("v", ck["v"], cd["v"])):
        err, good = worst(a, r, dtype_tol(torch.bfloat16))
        long_err[name] = dict(max_abs=err, rel_l2=rel_l2(a, r), ref_rms=float(r.float().pow(2).mean().sqrt()))
        if not good or long_err[name]["rel_l2"] > MAX_REL_L2:
            return fail(f"long prefill: {name} of the kernel path disagree with the plain path: {long_err[name]}")
    log(f"long prefill {BATCH}x{LONG} bf16: kernel path (masked GEMM + flash) {kernel_prefill_ms:.2f} ms, "
        f"plain path (fap + dense) {plain_prefill_ms:.2f} ms; launches masked_matmul {counts[0]}, "
        f"flash_attention {counts[1]}; " + "; ".join(
            f"{k}: max err {v['max_abs']:.3g} (rtol, atol {dtype_tol(torch.bfloat16)}), "
            f"rel L2 {v['rel_l2']:.3g} (<= {MAX_REL_L2}), ref RMS {v['ref_rms']:.3g}"
            for k, v in long_err.items()))
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- phase 5: the record -----------------------------------------------
    step = [mm_rows[("bfloat16", BATCH, i)] for i in range(len(cfg.gemm_shapes()))]
    step_sum = {key: sum(r[key] * r["uses"] for r in step) for key in ("ms", "plain_ms", "library_ms", "bound_ms", "cast_ms")}
    log(f"decode step (bf16, M={BATCH}), {per_step} masked GEMMs: kernel {step_sum['ms']:.4f} ms, "
        f"plain {step_sum['plain_ms']:.4f} ms, torch.matmul {step_sum['library_ms']:.4f} ms, "
        f"bound {step_sum['bound_ms']:.4f} ms; fault_linear's fp32->bf16 weight casts "
        f"{step_sum['cast_ms']:.4f} ms")
    fa = fa_rows[("bfloat16", LONG, "causal")]
    kernels = [
        dict(name="masked_matmul", route="cuda", source="src/repro_torch/kernels/csrc/masked_matmul.cu",
             replaces="src/repro/kernels/masked_matmul/masked_matmul.py:66",
             launches=launches["masked_matmul"], max_abs_err=mm_err,
             ms=step_sum["ms"], plain_ms=step_sum["plain_ms"], bound_ms=step_sum["bound_ms"],
             bound_by="bytes", library_ms=step_sum["library_ms"]),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/flash_attention.py:110",
             launches=launches["flash_attention"], max_abs_err=fa_err,
             ms=fa["ms"], plain_ms=fa["plain_ms"], bound_ms=fa["bound_ms"],
             bound_by="operations", library_ms=fa["library_ms"]),
    ]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, serve=serve_report, kernels=kernels, profile=profile_report,
        masked_matmul_rows=[dict(dtype=k[0], m=k[1], **v) for k, v in mm_rows.items()],
        flash_rows=[dict(dtype=k[0], s=k[1], case=k[2], **v) for k, v in fa_rows.items()],
        long_prefill=dict(kernel_ms=kernel_prefill_ms, plain_ms=plain_prefill_ms, err=long_err),
    ), indent=1))
    log("kernels: " + ", ".join(f"{k['name']} launches={k['launches']} max_abs_err={k['max_abs_err']:.3g}" for k in kernels))
    log("masked_matmul ms/plain_ms/library_ms/bound_ms: one bf16 decode step's 211 launches at M=4; "
        "flash_attention: one launch at 4x9x2048^2 causal bf16")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
