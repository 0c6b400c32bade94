"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure:

  1. the card: exit non-zero without CUDA; print the card's name and
     power limit as ``nvidia-smi`` reports them;
  2. build: compile every kernel of the serving path from ``csrc/``
     (one ``nvcc`` per source, all started together);
  3. kernels: each packed-GEMM kernel (K1 none, K2 sign, K3 affine
     epilogue) against its plain PyTorch version on the card,
     ``torch.equal``, at the serving path's shapes (M in {1, 32, 256}),
     at ragged and multi-chunk shapes, and with g < 0, g == 0 and exact
     tie columns; then CUDA-graph timings of the kernel, its plain
     version and ``torch.matmul`` on the unpacked ±1 bf16 operands;
  4. slice: ``bnn-mlp-large`` at full width (784-3072-1536-768-10) from
     a seeded ``torch.Generator`` with random BN statistics, frozen,
     exported, ``load_packed`` on ``cuda``, checked against the live
     eval model, then served by the port's HTTP server (batch 32) and
     queried through the port's client; the launch counters are zeroed
     just before this phase and read just after it. Then the frozen
     predictor's time per batch of 32 on the host clock and, from
     ``torch.profiler``, its device time and largest kernels.

The last lines are the per-kernel JSON lines, the ``{"kernels": [...]}``
line and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak, the lowest
# precision the data sheet lists; a ±1 GEMM counts 2*M*N*K operations

MAIN_M = 32  # the server's micro-batch: the shape the main path runs
LAYER2 = (3072, 1536)  # (K, N) of K2 in bnn-mlp-large
LAYER3 = (1536, 768)   # (K, N) of K3

KERNEL_ROWS = {
    # name -> (TPU kernel it replaces, main-path (K, N), on the main path)
    "xnor": ("distributed_mnist_bnns_tpu/ops/xnor_gemm.py:81", LAYER2, False),
    "xnor_sign": ("distributed_mnist_bnns_tpu/ops/xnor_gemm.py:124",
                  LAYER2, True),
    "xnor_affine": ("distributed_mnist_bnns_tpu/ops/xnor_gemm.py:149",
                    LAYER3, True),
}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def _pm1(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.where(torch.rand(*shape, generator=gen) > 0.5, 1.0, -1.0)


def _sign_vectors(gen, n: int, o_row: torch.Tensor):
    """(a, t, bias) of K2 from BN parameters with g > 0, g < 0 and
    g == 0 columns, through the port's own folding; every fourth column
    gets a threshold equal to row 0's value, an exact >= tie."""
    from distributed_mnist_bnns_tpu_torch.infer import _bn_sign_epilogue

    g = torch.randn(n, generator=gen)
    g[::5] = 0.0
    g[1::3] = -g[1::3].abs()
    params = {"scale": g, "bias": torch.randn(n, generator=gen)}
    stats = {"mean": torch.randn(n, generator=gen) * 8.0,
             "var": torch.rand(n, generator=gen) * 50.0 + 1.0}
    a, t = _bn_sign_epilogue(params, stats)
    bias = torch.randn(n, generator=gen)
    ties = torch.arange(n) % 4 == 0
    t = torch.where(ties, a * (o_row.cpu() + bias), t)
    return a, t, bias


def _affine_vectors(gen, n: int):
    a = torch.randn(n, generator=gen) / 16.0
    a[::7] = 0.0
    c = torch.randn(n, generator=gen)
    bias = torch.randn(n, generator=gen)
    return a, c, bias


def _graph_ms(fn, iters: int = 50, reps: int = 15) -> float:
    """Median device time of one ``fn()``: ``iters`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events, so host
    launch overhead is not in the number. Operands stay in L2 between
    calls, as the serving path's weights do from batch to batch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _bound(name: str, m: int, k: int, n: int):
    """Least time (ms) the card could take for the kernel's function:
    packed x and the real weight words read once, the epilogue vectors
    read once, the fp32 output written once, against HBM bandwidth; and
    2*M*N*K ±1 operations against the int8 tensor-core peak."""
    kw = -(-k // 32)
    vecs = 0 if name == "xnor" else 3
    nbytes = 4 * (m * kw + kw * n + vecs * n + m * n)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = 2.0 * m * n * k / H100_INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(name: str, device: torch.device, gen: torch.Generator):
    """Compare kernel ``name`` with its plain version at every listed
    shape; time it at the main path's shapes. Returns the timing rows
    and the largest absolute difference seen."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops import xnor_gemm as xg
    from distributed_mnist_bnns_tpu_torch.ops.bitpack import pack_bits

    _, main_kn, _ = KERNEL_ROWS[name]
    shapes = [(m, *main_kn) for m in (1, MAIN_M, 256)]
    shapes += [(17, 100, 130), (5, 31, 1), (3, 4160, 200), (9, 9000, 257)]
    max_err = 0.0
    rows = []
    for m, k, n in shapes:
        x = _pm1(gen, m, k).to(device)
        wp, _, _ = xg.prepack_weights(_pm1(gen, k, n).to(device))
        xp = pack_bits(x)
        if name == "xnor":
            vecs = ()
            entry = xg.xnor_matmul_packed
            plain = xg.xnor_gemm_plain
        elif name == "xnor_sign":
            o_row = xg.xnor_gemm_plain(xp[:1], wp, k)[0, :n]
            vecs = _sign_vectors(gen, n, o_row)
            entry = xg.xnor_matmul_packed_sign
            plain = xg.xnor_sign_plain
        else:
            vecs = _affine_vectors(gen, n)
            entry = xg.xnor_matmul_packed_affine
            plain = xg.xnor_affine_plain
        vecs = tuple(v.to(device) for v in vecs)
        got = entry(x, wp, k, n, *vecs)
        want = plain(xp, wp, k, *vecs)[:, :n]
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(
                f"{name} at (M={m}, K={k}, N={n}) differs from its plain "
                f"version: max |diff| = {err}"
            )
        if name == "xnor_sign":
            ties = (torch.arange(n, device=device) % 4 == 0)
            if not bool((got[0][ties] == 1.0).all()):
                raise AssertionError(f"{name}: an exact tie did not give +1")
        if (k, n) != main_kn:
            continue
        vf = tuple(v.to(torch.float32).contiguous() for v in vecs)
        xb = x.to(torch.bfloat16)
        wb = xg.unpacked_pm1(wp, k, n, torch.bfloat16).contiguous()
        row = {
            "kernel": name, "m": m, "k": k, "n": n,
            "kernel_ms": _graph_ms(
                lambda: _kernels.xnor_gemm(name, xp, wp, k, n, *vf)),
            "entry_ms": _graph_ms(lambda: entry(x, wp, k, n, *vecs)),
            "plain_ms": _graph_ms(lambda: plain(xp, wp, k, *vecs)),
            "library_ms": _graph_ms(lambda: torch.matmul(xb, wb)),
        }
        row["bound_ms"], row["bound_by"] = _bound(name, m, k, n)
        rows.append(row)
        print(json.dumps(row), flush=True)
    torch.cuda.synchronize()
    return rows, max_err


def _random_bn_stats(model, gen) -> None:
    """Non-trivial eval statistics: running means and variances on the
    scale of each layer's pre-activations, scales with negative and
    exactly-zero entries, non-zero biases."""
    fan_in = (784, model.hidden[0], model.hidden[1])
    with torch.no_grad():
        for bn, fi in zip((model.bn1, model.bn2, model.bn3), fan_in):
            c = bn.num_features
            bn.running_mean.copy_(torch.randn(c, generator=gen) * fi ** 0.5 / 4)
            bn.running_var.copy_((torch.rand(c, generator=gen) + 0.5) * fi / 4)
            w = torch.randn(c, generator=gen)
            w[::11] = 0.0
            bn.weight.copy_(w)
            bn.bias.copy_(torch.randn(c, generator=gen) * 0.5)


def slice_phase(device: torch.device, gen: torch.Generator,
                model_name: str = "bnn-mlp-large", batch: int = MAIN_M):
    """Freeze, export, load and serve ``model_name``; check every answer.
    Returns (counts of launches in the phase, timing dict)."""
    from distributed_mnist_bnns_tpu_torch.infer import (
        export_packed,
        load_packed,
    )
    from distributed_mnist_bnns_tpu_torch.models import get_model
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.serve import (
        PackedInferenceServer,
        ServeConfig,
    )
    from distributed_mnist_bnns_tpu_torch.serve import client

    model = get_model(model_name, generator=gen)
    _random_bn_stats(model, gen)
    model.eval()
    # Pixels are multiples of 1/256: exact in bf16 and fp32, so the live
    # model's bf16 first layer and the frozen fp32 one give equal sums.
    images = torch.randint(0, 256, (batch, 28, 28, 1), generator=gen) / 256.0

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.pt")
        _kernels.reset_launches()
        info = export_packed(model, path)
        fn, _ = load_packed(path, device=device)
        frozen = fn(images)
        live = model.to(device)(images.to(device))
        torch.cuda.synchronize()
        diff = (frozen - live).abs().max().item()
        if not (torch.equal(frozen.argmax(-1), live.argmax(-1))
                and diff <= 1e-4 and frozen.shape == (batch, 10)
                and bool(torch.isfinite(frozen).all())):
            raise AssertionError(
                f"frozen vs live eval: max |diff| = {diff}, argmax equal "
                f"{torch.equal(frozen.argmax(-1), live.argmax(-1))}"
            )
        log(f"frozen == live eval (max |diff| {diff:.3g}); {info}")

        srv = PackedInferenceServer(ServeConfig(
            artifact=path, device=str(device), port=0, batch_size=batch,
            default_deadline_ms=30000.0, stall_timeout_s=30.0,
        ))
        host, port = srv.start()
        base = f"http://{host}:{port}"
        try:
            code, body = client.healthz(base)
            if code != 200 or json.loads(body)["status"] != "ok":
                raise AssertionError(f"/healthz: {code} {body[:200]!r}")
            imgs = images.numpy()
            answers = []
            lat = []
            for i, n_req in enumerate((1, batch, 3, batch, 7)):
                x = np.roll(imgs, -5 * i, axis=0)[:n_req]
                t0 = time.perf_counter()
                code, body = client.predict(base, x.tolist())
                lat.append(time.perf_counter() - t0)
                if code != 200:
                    raise AssertionError(f"/predict: {code} {body[:200]!r}")
                answers.append((x, json.loads(body)))
        finally:
            srv.request_stop("smoke over")
            stats = srv.drain_and_stop()
        counts = dict(_kernels.LAUNCHES)
        if not stats["flushed"]:
            raise AssertionError(f"drain did not flush: {stats}")
        # Checked after the counts are read: these predictor calls are
        # the reference, not the path under test.
        for x, out in answers:
            n_req = x.shape[0]
            padded = np.zeros((batch, 28, 28, 1), np.float32)
            padded[:n_req] = x
            want = fn(padded)[:n_req].cpu().numpy()
            got = np.asarray(out["log_probs"], np.float32)
            if out["argmax"] != want.argmax(-1).tolist() \
                    or not np.allclose(got, want, atol=1e-6, rtol=0):
                raise AssertionError(
                    f"/predict of {n_req} differs from the predictor: "
                    f"max |diff| {np.abs(got - want).max()}"
                )
        served = sum(x.shape[0] for x, _ in answers)
        log(f"served {served} examples in {len(answers)} requests, each "
            f"equal to the predictor; drain {stats}")

    x32 = images.to(device)
    ms = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(x32)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    device_ms, top = _profile_device_ms(lambda: fn(x32))
    t0 = time.perf_counter()
    json.dumps({"images": imgs.tolist()})
    timing = {
        "predict_ms_batch": statistics.median(ms),
        "predict_device_ms_batch": device_ms,
        "predict_device_busy_share": (
            None if device_ms is None else device_ms / statistics.median(ms)
        ),
        "predict_top_device_ms": top,
        "request_ms_median": statistics.median(lat) * 1e3,
        "request_json_encode_ms_batch": (time.perf_counter() - t0) * 1e3,
    }
    return counts, timing


def _profile_device_ms(fn, calls: int = 20):
    """Device time of one ``fn()`` from ``torch.profiler``: the sum of
    the CUDA kernels' own times over ``calls`` calls, and the six
    largest kernels (name, ms per call, launches per call). None when
    the profiler reports no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None, []
    kernels.sort(key=lambda e: -e.self_device_time_total)
    total_us = sum(e.self_device_time_total for e in kernels)
    top = [[e.key[:70], e.self_device_time_total / calls / 1e3,
            e.count / calls] for e in kernels[:6]]
    return total_us / calls / 1e3, top


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    print(json.dumps({"python": sys.version.split()[0],
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)

    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    built = _kernels.build()
    print(json.dumps({"build_s": round(time.perf_counter() - t0, 3),
                      "sources": built}), flush=True)

    gen = torch.Generator().manual_seed(0)
    results = {}
    for name in KERNEL_ROWS:
        results[name] = kernel_phase(name, device, gen)
        torch.cuda.synchronize()
        log(f"{name}: equal to its plain version at every shape")

    counts, timing = slice_phase(device, gen)
    print(json.dumps({"slice": "bnn-mlp-large", "launches": counts,
                      **timing}), flush=True)
    for name, (_, _, on_path) in KERNEL_ROWS.items():
        if on_path and counts[name] == 0:
            raise AssertionError(f"the main path never launched {name}")

    kernels = []
    for name, (replaces, _, on_path) in KERNEL_ROWS.items():
        rows, max_err = results[name]
        row = next(r for r in rows if r["m"] == MAIN_M)
        entry = {
            "name": name, "route": "cuda",
            "source": "distributed_mnist_bnns_tpu_torch/csrc/xnor_gemm.cu",
            "replaces": replaces, "launches": counts[name],
            "on_main_path": on_path, "max_abs_err": max_err,
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": [row["m"], row["k"], row["n"]],
        }
        print(json.dumps({"kernel": name, "kernel_ms": entry["ms"],
                          "plain_ms": entry["plain_ms"],
                          "library_ms": entry["library_ms"],
                          "launches": entry["launches"]}), flush=True)
        kernels.append(entry)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
