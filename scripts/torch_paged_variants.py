"""Time variants of K8 (``csrc/paged_attn.cu``) on a CUDA card: each
variant is the source with some of its lines replaced, built with the
package's ``nvcc`` flags into a temporary directory and bound as the
package binds the kernel.

    python scripts/torch_paged_variants.py VARIANTS_JSON

``VARIANTS_JSON`` maps a name to a list of [old, new] string
replacements, for example
``'{"base": [], "r4nk4": [["constexpr int R = 8;", "constexpr int R = 4;"],
["constexpr int NK = 2;", "constexpr int NK = 4;"]]}'``. A variant whose
name starts with ``x`` is an ablation that may compute wrong outputs;
every other one must stay within 1e-5 of the gather path at every shape.
Prints what ``ptxas`` says of each variant, then, twice over all
variants in turn, one JSON line per variant with its CUDA-graph time in
microseconds (``chip_smoke._graph_ms``) at decode (S, C) = (4, 1) with
qpos 255 and 20, prefill (1, 16) at positions 240-255 and 32-47 and
verify (4, 4) at 252-255, pages of 16, P = 16, H = 4, D = 64.

Exits 1 without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch
from torch_paged_timing import paged_cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_paged_variants: no CUDA device available",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops import paged_kv as pk

    variants = json.loads(sys.argv[1])
    with open(os.path.join(_kernels.CSRC_DIR, "paged_attn.cu")) as f:
        source = f.read()
    tmp = tempfile.mkdtemp(prefix="paged_variants_")
    procs = {}
    for name, subs in variants.items():
        src = source
        for old, new in subs:
            if old not in src:
                raise ValueError(f"variant {name}: {old!r} not in the source")
            src = src.replace(old, new)
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        so = os.path.join(tmp, f"lib{name}.so")
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v",
               "-I", _kernels.CSRC_DIR, "-o", so, path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    fns = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} does not build:\n{log}")
        print(json.dumps({"variant": name, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]}), flush=True)
        fn = ctypes.CDLL(so).paged_attn
        fn.argtypes = _kernels.SIGNATURES["paged_attn.cu"]["paged_attn"]
        fn.restype = ctypes.c_int
        fns[name] = fn

    device = torch.device("cuda", 0)
    cases = paged_cases(cs, torch.Generator().manual_seed(0), device)
    names = ("dec255", "dec20", "pre240", "pre32", "ver")

    def call(fn, q, qpos, kp, vp, tb):
        out = torch.empty_like(q)
        s, c, h, d = q.shape
        err = fn(q.data_ptr(), qpos.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                 tb.data_ptr(), out.data_ptr(), s, c, h, d, kp.shape[1],
                 tb.shape[1], kp.shape[0], d ** -0.5,
                 torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out

    for rep in range(2):
        for name, fn in fns.items():
            row = {"variant": name, "rep": rep}
            for what, (_, (q, qpos, kp, vp, tb)) in zip(names, cases):
                got = call(fn, q, qpos, kp, vp, tb)
                err = (got - pk.paged_attn_plain(q, qpos, kp, vp, tb)).abs()
                if not name.startswith("x") and err.max().item() > 1e-5:
                    raise AssertionError(f"{name} {what}: {err.max().item()}")
                row[what] = cs._graph_ms(
                    lambda: call(fn, q, qpos, kp, vp, tb)) * 1e3
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
