#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each raising on failure (non-zero exit):

1. build   -- compile every CUDA source under ``src/repro_torch/csrc`` with
              nvcc, one process per source, all at once.
2. kernels -- each hand-written kernel against its plain PyTorch version on
              the card, at the main path's shapes and at the edges, with its
              time (CUDA events, L2 flushed before each call), the plain
              version's time, a PyTorch library call's time where one
              computes the same function, and the bound: the larger of bytes
              moved over 3.35 TB/s and operations over the f32 peak.
3. model   -- decode-vs-full-forward agreement on a small f32 config: one
              paged decode step through the kernel equals the last row of a
              full forward pass.
4. main    -- llama3.2-3b at full width (bf16, seeded random weights):
              cold start, a batch of 4 prompts with 32 new tokens each, a
              REAP record, descent to HIBERNATED, and a continuation of one
              session plus a new session served through a REAP wake, all
              against a never-slept twin.  Every kernel's launch counter is
              zeroed before this phase and must be positive after it.
5. profile -- one more batch on the twin under torch.profiler: device
              kernel time by kind against the batch's wall time.
6. card    -- the card's name and power limit from nvidia-smi.

The last lines are a ``{"kernels": [...]}`` JSON line, the nvidia-smi
line and ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
port's sources beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SPOOL = ROOT / "build" / "chip_smoke_spool"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
F32_FLOPS = 67e12               # H100 SXM f32 outside the tensor cores
ARCH = "llama3.2-3b"
PROMPTS = (64, 200, 257, 512)
NEW_TOKENS = 32
CONT_PROMPT, NEW_PROMPT, PROBE_PROMPT = 48, 128, 16
SEED = 0
F32_TOL = dict(rtol=2e-5, atol=2e-5)      # tests/test_kernels.py tolerances
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def log(msg: str) -> None:
    print(msg, flush=True)


class Timer:
    """Median device time of one call (CUDA events), with the 50 MB L2
    flushed before each call, as a caller on the main path finds it."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 15) -> float:
        torch = self.torch
        fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# the main path's shapes, known before it runs
# ---------------------------------------------------------------------------

def plan(cfg, page_elems: int) -> dict:
    page_tokens = page_elems // (2 * cfg.num_kv_heads * cfg.head_dim)
    final = [p + NEW_TOKENS - 1 for p in PROMPTS]      # cache rows at the end
    pages = [math.ceil(n / page_tokens) for n in final]
    return {"page_tokens": page_tokens, "decode_lengths": final,
            "deflate_pages": sum(pages) * cfg.num_layers,
            "fault_pages": pages[0] * cfg.num_layers}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def measured(timer, label, err, kernel, plain, library, nbytes, flops):
    """Time one check's kernel, plain version and library call, log the
    line, and return the kernel-line numbers."""
    bms, by = bound_ms(nbytes, flops)
    rec = {"max_abs_err": err, "ms": timer.ms(kernel),
           "plain_ms": timer.ms(plain),
           "library_ms": timer.ms(library) if library else None,
           "bound_ms": bms, "bound_by": by}
    lib = "n/a" if rec["library_ms"] is None else f"{rec['library_ms']:.4f}"
    log(f"  {label}: max_abs_err={err:.3e} ms={rec['ms']:.4f} "
        f"plain_ms={rec['plain_ms']:.4f} library_ms={lib} "
        f"bound_ms={bms:.4f} ({by})")
    return rec


def check_paged_attention(torch, timer, shapes, page_elems):
    from repro_torch.kernels.paged_attention import ops as pa
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    P = 4096
    pool = torch.randn(P, page_elems, generator=gen, device="cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    main = None
    cases = [  # name, H, Hkv, D, lengths, window, q dtype
        ("main", 24, 8, 128, shapes["decode_lengths"], 0, torch.bfloat16),
        ("main-f32", 24, 8, 128, shapes["decode_lengths"], 0, torch.float32),
        ("window", 24, 8, 128, shapes["decode_lengths"], 37, torch.bfloat16),
        ("G7", 7, 1, 128, [5, 300, 0], 0, torch.float32),
        ("G7-bf16-window", 7, 1, 128, [5, 300, 129], 100, torch.bfloat16),
        ("D64", 4, 2, 64, [1, 64, 130], 0, torch.float32),
        ("D64-window", 4, 2, 64, [1, 64, 130], 17, torch.float32),
    ]
    for name, H, Hkv, D, lengths, window, qdt in cases:
        T = page_elems // (2 * Hkv * D)
        B, G = len(lengths), H // Hkv
        pps = max(1, math.ceil(max(lengths) / T))
        table = torch.randperm(P, generator=gen, device="cuda")[:B * pps] \
            .reshape(B, pps).to(torch.int32)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        q = torch.randn(B, H, D, generator=gen, device="cuda").to(qdt)
        kw = dict(num_kv_heads=Hkv, page_tokens=T, window=window)
        out = pa.paged_decode_attention(q, pool, table, lens, **kw)
        ref = pa.paged_decode_attention_plain(q, pool, table, lens, **kw)
        torch.cuda.synchronize()
        tol = BF16_TOL if qdt == torch.bfloat16 else F32_TOL
        require(torch.allclose(out.float(), ref.float(), **tol),
                f"paged_attention[{name}] disagrees with its plain version "
                f"(max_abs_err {max_err(out, ref):.3e}, tol {tol['atol']})")
        # the bound reads each valid K/V row once
        used = [min(n, pps * T) - (max(0, n - window) if window else 0)
                for n in lengths]
        nbytes = (sum(used) * 2 * Hkv * D * 4 + 2 * q.numel() * q.element_size()
                  + table.numel() * 4 + lens.numel() * 4)
        # yardstick: SDPA over the same K/V already gathered into a dense
        # (B, H, S, D) cache with the same mask (the gather is not timed)
        S = pps * T
        kv = pool[table.long()][:, :, :T * 2 * Hkv * D].reshape(B, S, 2, Hkv, D)
        k = kv[:, :, 0].repeat_interleave(G, 2).transpose(1, 2).to(qdt)
        v = kv[:, :, 1].repeat_interleave(G, 2).transpose(1, 2).to(qdt)
        pos, n = torch.arange(S, device="cuda")[None], lens[:, None].long()
        mask = (pos < n) & ((pos > n - 1 - window) if window else True)
        mask, qs = mask[:, None, None, :], q[:, :, None, :]
        rec = measured(
            timer, f"paged_attention[{name}] B={B} H={H} Hkv={Hkv} D={D} "
            f"T={T} lengths={lengths} window={window} q={str(qdt)[6:]} "
            f"tol={tol['atol']:g}", max_err(out, ref),
            lambda: pa.paged_decode_attention(q, pool, table, lens, **kw),
            lambda: pa.paged_decode_attention_plain(q, pool, table, lens, **kw),
            lambda: sdpa(qs, k, v, attn_mask=mask), nbytes,
            sum(used) * Hkv * 4 * G * D)
        if name == "main":
            main = {"name": "paged_attention", "route": "cuda",
                    "source": "src/repro_torch/csrc/paged_attention.cu",
                    "replaces": "src/repro/kernels/paged_attention/kernel.py:35",
                    **rec}
    return [main]


def check_page_copy(torch, timer, shapes, page_elems):
    from repro_torch.kernels.page_copy import ops as pc
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    out = []

    def pool_of(dtype, P):
        if dtype == torch.int32:
            return torch.randint(-2**31, 2**31 - 1, (P, page_elems),
                                 generator=gen, device="cuda", dtype=dtype)
        return torch.randn(P, page_elems, generator=gen, device="cuda").to(dtype)

    def bits(t):
        return t.contiguous().view(torch.uint8)

    def copy_bytes(pool, n):             # each page read once, written once
        return 2 * n * page_elems * pool.element_size() + n * 8

    # gather: the deflate export of every resident page, plus the edges
    big = pool_of(torch.float32, 1 << 15)                 # the 2 GiB pool
    for name, pool, idx in (
            ("main", big, torch.randperm(big.shape[0], generator=gen,
                                         device="cuda")[:shapes["deflate_pages"]]),
            ("repeat", big, torch.randint(0, 8, (64,), generator=gen,
                                          device="cuda")),
            ("bf16", pool_of(torch.bfloat16, 2048),
             torch.randperm(2048, generator=gen, device="cuda")[:256]),
            ("int32", pool_of(torch.int32, 2048),
             torch.randperm(2048, generator=gen, device="cuda")[:256])):
        got = pc.gather_pages(pool, idx)
        ref = pc.gather_pages_plain(pool, idx)
        torch.cuda.synchronize()
        require(torch.equal(bits(got), bits(ref)),
                f"page_gather[{name}] differs from its plain version")
        rec = measured(
            timer, f"page_gather[{name}] n={idx.numel()} page={page_elems} "
            f"{str(pool.dtype)[6:]} bit-exact", max_err(got, ref),
            lambda: pc.gather_pages(pool, idx),
            lambda: pc.gather_pages_plain(pool, idx),
            lambda: torch.index_select(pool, 0, idx),
            copy_bytes(pool, idx.numel()), 0)
        if name == "main":
            out.append({"name": "page_gather", "route": "cuda",
                        "source": "src/repro_torch/csrc/page_copy.cu",
                        "replaces": "src/repro/kernels/page_copy/kernel.py:30",
                        **rec})

    # scatter: the fault install of the continuing session's pages; every
    # other page must keep its bits
    for name, pool, n in (("main", big, shapes["fault_pages"]),
                          ("bf16", pool_of(torch.bfloat16, 2048), 300),
                          ("int32", pool_of(torch.int32, 2048), 300)):
        idx = torch.randperm(pool.shape[0], generator=gen, device="cuda")[:n]
        buf = pool_of(pool.dtype, n)
        expect = pool.clone()
        pc.scatter_pages_plain(expect, idx, buf)
        pc.scatter_pages(pool, idx, buf)
        torch.cuda.synchronize()
        require(torch.equal(bits(pool), bits(expect)),
                f"page_scatter[{name}] differs from its plain version")
        err = max_err(pool, expect)
        del expect
        rec = measured(
            timer, f"page_scatter[{name}] n={n} of {pool.shape[0]} pages "
            f"{str(pool.dtype)[6:]} whole pool bit-exact", err,
            lambda: pc.scatter_pages(pool, idx, buf),
            lambda: pc.scatter_pages_plain(pool, idx, buf),
            lambda: pool.index_copy_(0, idx, buf), copy_bytes(pool, n), 0)
        if name == "main":
            out.append({"name": "page_scatter", "route": "cuda",
                        "source": "src/repro_torch/csrc/page_copy.cu",
                        "replaces": "src/repro/kernels/page_copy/kernel.py:35",
                        **rec})
    return out


# ---------------------------------------------------------------------------
# phase 3: the model's paged decode against its own full forward
# ---------------------------------------------------------------------------

def check_model(torch):
    import numpy as np
    from repro_torch.configs import get_config, tiny_config
    from repro_torch.core.pool import PagePool
    from repro_torch.models import model
    from repro_torch.serving.paged_kv import PagedKVCache
    from repro_torch.weights import init_params

    cfg = tiny_config(get_config(ARCH))
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                         "cuda")
    pool = PagePool(16384, capacity_pages=1024, device="cuda")
    kv = PagedKVCache("check", cfg, pool)
    kv.new_session("c")
    S = 70                                   # crosses a 64-token page
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, S + 1), device="cuda")[None]
    full = model.logits_full(params, cfg, toks)[0, -1]
    _, caches = model.forward_hidden(params, cfg, toks[:, :S],
                                     collect_cache=True)
    for layer in range(cfg.num_layers):
        kv.write_tokens("c", layer, torch.stack(
            [caches["k"][layer, 0], caches["v"][layer, 0]], 1), 0)
        kv.reserve_tokens("c", layer, S, 1)
    L = cfg.num_layers
    tables = torch.from_numpy(np.stack(
        [kv.page_table(["c"], layer) for layer in range(L)])).cuda()
    slots = torch.from_numpy(np.stack(
        [kv.token_offsets("c", layer, S, 1) for layer in range(L)])).cuda()
    dec = model.decode_step(params, cfg, toks[:, S], pool.data, tables, slots,
                            torch.tensor([S + 1], dtype=torch.int32,
                                         device="cuda"),
                            page_tokens=kv.page_tokens)[0]
    err = max_err(dec, full)
    log(f"  decode step vs full forward (tiny f32, S={S}): max_abs_err="
        f"{err:.3e} (tol 1e-4)")
    require(torch.allclose(dec, full, rtol=1e-4, atol=1e-4),
            "paged decode disagrees with the full forward pass")


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

def main_path(torch, cfg, counters):
    import numpy as np
    from repro_torch.core.manager import InstanceManager, ManagerConfig
    from repro_torch.core.state import Rung
    from repro_torch.serving import Request, ServingEngine, decode_steps
    from repro_torch.weights import init_params

    def factory(arch_key):
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        return cfg, init_params(cfg, gen, "cuda")

    mgr = InstanceManager(ManagerConfig(spool_dir=str(SPOOL), device="cuda"),
                          factory)
    eng = ServingEngine(mgr)
    rng = np.random.default_rng(SEED)
    V = cfg.vocab_size
    prompts = [rng.integers(0, V, n).astype(np.int32) for n in PROMPTS]
    probe = rng.integers(0, V, PROBE_PROMPT).astype(np.int32)
    cont = rng.integers(0, V, CONT_PROMPT).astype(np.int32)
    fresh = rng.integers(0, V, NEW_PROMPT).astype(np.int32)

    def batch(iid):
        return [Request(iid, f"s{j}", p, max_new_tokens=NEW_TOKENS)
                for j, p in enumerate(prompts)]

    def continuation(iid):
        return [Request(iid, "s0", cont, max_new_tokens=NEW_TOKENS),
                Request(iid, "new", fresh, max_new_tokens=NEW_TOKENS)]

    def sample(iid):
        return Request(iid, "probe", probe, max_new_tokens=2,
                       close_session=True)

    for c in counters:
        c.launches = 0
    t0 = time.monotonic()
    tenant = eng.start_instance("tenant", ARCH)
    torch.cuda.synchronize()
    cold_s = time.monotonic() - t0
    eng.start_instance("twin", ARCH)

    # the twin's batch goes first and absorbs the process's one-time CUDA
    # library set-up, so the tenant's numbers are those of a warm process
    twin_first = eng.serve_batch("twin", batch("twin"))
    first = eng.serve_batch("tenant", batch("tenant"))
    steps = decode_steps([NEW_TOKENS] * len(PROMPTS))
    decode_s = eng.trace.spans["decode"][-1]
    for r in first:
        require(len(r.tokens) == NEW_TOKENS
                and all(0 <= t < V for t in r.tokens),
                f"bad token stream for {r.request.session_id}")
    require([r.tokens for r in first] == [r.tokens for r in twin_first],
            "tenant and twin disagree before hibernation")
    eng.record_sample("tenant", sample("tenant"))

    torch.cuda.synchronize()
    mem_warm = torch.cuda.memory_allocated()
    wbytes = sum(t.numel() * t.element_size() for t in tenant.weights.values())
    dst = mgr.descend("tenant", Rung.HIBERNATED)
    mem_hib = torch.cuda.memory_allocated()
    require(tenant.weight_bytes() == 0, "weights still resident after deflate")
    require(mem_warm - mem_hib >= wbytes,
            f"deflate freed {mem_warm - mem_hib} B of device memory, "
            f"less than the {wbytes} B of weights")

    eng.record_sample("twin", sample("twin"))

    woken = eng.serve_batch("tenant", continuation("tenant"))
    wake = [st for kind, iid, st in mgr.hib.log
            if kind == "wake" and iid == "tenant"][-1]
    twin_cont = eng.serve_batch("twin", continuation("twin"))
    require((woken[0].state_before, woken[0].state_after)
            == ("hibernate", "woken"), "continuation did not run the wake")
    require([r.tokens for r in woken] == [r.tokens for r in twin_cont],
            "woken tenant's tokens differ from the never-slept twin's")
    require(woken[0].faults > 0 and wake.prefetched_bytes >= wbytes,
            "REAP wake did not restore the weights / fault the session")

    nums = {
        "layers": cfg.num_layers,
        "cold_start_s": cold_s,
        "ttft_ms": [r.spans["ttft"] * 1e3 for r in first],
        "prefill_ms": [t * 1e3 for t in eng.trace.spans["prefill"][4:8]],
        "process_first_batch_ttft_ms": [r.spans["ttft"] * 1e3
                                        for r in twin_first],
        "decode_ms_per_step": decode_s / steps * 1e3,
        "decode_ms_per_token": decode_s / (steps * len(PROMPTS)) * 1e3,
        "decode_batch": len(PROMPTS),
        "weight_bytes": wbytes,
        "hbm_freed_by_deflate": mem_warm - mem_hib,
        "deflate_s": dst.seconds,
        "deflate_reap_bytes": dst.reap_bytes,
        "deflate_swap_bytes": dst.swap_bytes,
        "deflate_kv_pages": dst.kv_pages_swapped,
        "wake_s": wake.seconds,
        "wake_io_s": wake.io_seconds,
        "wake_install_s": wake.inflate_seconds,
        "woken_ttft_ms": woken[0].spans["ttft"] * 1e3,
        "woken_faults": woken[0].faults,
        "woken_faulted_bytes": woken[0].faulted_bytes,
        "twin_continuation_ttft_ms": twin_cont[0].spans["ttft"] * 1e3,
    }
    return nums, dst, eng, prompts


def profile_decode(torch, eng, prompts):
    """One more batch on the twin (4 short prompts, 9 new tokens: decode
    dominates) under torch.profiler: device kernel time by kind against
    the wall time of the batch.  Runs after the launch counters are read."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import Request

    reqs = [Request("twin", f"prof{j}", p[:16], max_new_tokens=9)
            for j, p in enumerate(prompts)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        eng.serve_batch("twin", reqs)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    kinds = {"paged_attention": ("paged_decode",),
             "matmul": ("gemm", "gemv", "nvjet", "cutlass", "xmma", "cublas",
                        "splitk"),
             "page_copy": ("page_copy",),
             "elementwise": ("elementwise",), "reduce": ("reduce",),
             "index": ("index", "gather", "scatter")}
    by_kind, top = {}, []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if not us or e.device_type.name != "CUDA":
            continue
        kind = next((k for k, pats in kinds.items()
                     if any(p in e.key.lower() for p in pats)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
        top.append((us / 1e3, e.count, e.key[:60]))
    device_ms = sum(by_kind.values())
    return {"wall_ms": wall_ms, "device_kernel_ms": device_ms,
            "device_busy_share": device_ms / wall_ms if wall_ms else None,
            "kernel_ms_by_kind": by_kind,
            "top_kernels": sorted(top, reverse=True)[:8]}


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.core.manager import ManagerConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.page_copy import ops as pc
    from repro_torch.kernels.paged_attention import ops as pa

    t_all = time.monotonic()
    log("== build")
    t0 = time.monotonic()
    out = _build.build_all(["paged_attention", "page_copy"],
                           extra=("-Xptxas", "-v"))
    for name, text in out.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    log(f"  built {sorted(out)} in {time.monotonic() - t0:.1f} s")

    cfg = get_config(ARCH)                  # full width and full depth
    page_elems = ManagerConfig.pool_page_elems
    shapes = plan(cfg, page_elems)
    log(f"== kernels (main path shapes: {shapes})")
    timer = Timer(torch)
    kernels = check_paged_attention(torch, timer, shapes, page_elems)
    kernels += check_page_copy(torch, timer, shapes, page_elems)
    del timer
    torch.cuda.empty_cache()

    log("== model")
    check_model(torch)

    log(f"== main path: {ARCH} d_model={cfg.d_model} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads} head_dim={cfg.head_dim} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size} {cfg.dtype}, all {cfg.num_layers} layers")
    counters = {"paged_attention": pa.paged_decode_attention,
                "page_gather": pc.gather_pages,
                "page_scatter": pc.scatter_pages}
    shutil.rmtree(SPOOL, ignore_errors=True)
    try:
        nums, dst, eng, prompts = main_path(torch, cfg, counters.values())
        for k in kernels:
            k["launches"] = counters[k["name"]].launches
            require(k["launches"] > 0,
                    f"{k['name']} never launched on the main path")
        require(dst.kv_pages_swapped == shapes["deflate_pages"],
                "deflate exported another page count than planned")
        log("  main path: " + json.dumps(nums))
        log(f"  launches: { {k['name']: k['launches'] for k in kernels} }")
        log("== profile (twin, 4 x 16-token prompts, 9 new tokens)")
        try:
            prof = profile_decode(torch, eng, prompts)
        except Exception as e:     # a measurement only: report, go on
            prof = {"profile_failed": repr(e)}
        log("  " + json.dumps(prof))
    finally:
        shutil.rmtree(SPOOL, ignore_errors=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"== total {time.monotonic() - t_all:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
