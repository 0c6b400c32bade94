"""Time variants of K1-K3 (``csrc/xnor_gemm.cu``) on a CUDA card: each
variant is the source with some of its lines replaced, built with the
package's ``nvcc`` flags into a temporary directory and bound as the
package binds the kernels.

    python scripts/torch_xnor_variants.py VARIANTS_JSON

``VARIANTS_JSON`` maps a name to a list of [old, new] string
replacements, for example ``'{"base": [], "pq8": [["constexpr int PQ =
16;", "constexpr int PQ = 8;"]]}'``, or to the path of a whole source
with the same launchers (an earlier design). A variant whose name starts with
``x`` is an ablation that may compute wrong outputs; every other one must
equal the plain versions (``torch.equal``) at every shape it is timed at,
on ±1 x and, under both pack rules, on raw x with zeros, -0.0, NaN and
subnormals. Prints what ``ptxas`` says of each variant, then, twice over
all variants in turn, one JSON line per variant with its CUDA-graph time
in microseconds (``chip_smoke._graph_ms``) at each (kernel, M, K, N,
block_n, most blocks sharing x) of ``CASES``: the LM's decode projection
(K1 at M = 4 and 1), the MLP's layers 2 (K2) and 3 (K3) at its
micro-batch of 32, and K2 at M = 256, at the tile widths and cluster
sizes ``ops._kernels.xnor_tiling`` chooses among.

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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SYMBOLS = {"xnor": "xnor_gemm_none", "xnor_sign": "xnor_gemm_sign",
           "xnor_affine": "xnor_gemm_affine"}
# (kernel, M, K, N, block_n, most blocks of a cluster sharing x)
CASES = [("xnor", 4, 256, 512, 32, 8), ("xnor", 1, 256, 512, 32, 8),
         ("xnor", 4, 512, 256, 32, 8)]
CASES += [("xnor_sign", 32, 3072, 1536, bn, sh)
          for bn, sh in ((64, 8), (64, 4), (128, 6), (32, 8))]
CASES += [("xnor_affine", 32, 1536, 768, bn, sh)
          for bn, sh in ((32, 8), (64, 8), (32, 4))]
CASES += [("xnor_sign", 256, 3072, 1536, 128, sh) for sh in (6, 3)]
CASES += [("xnor_sign", 1, 3072, 1536, 32, sh) for sh in (2, 8)]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_xnor_variants: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops import xnor_gemm as xg
    from distributed_mnist_bnns_tpu_torch.ops.binarize import _sign_pm1
    from distributed_mnist_bnns_tpu_torch.ops.bitpack import pack_bits

    variants = json.loads(sys.argv[1])
    with open(os.path.join(_kernels.CSRC_DIR, "xnor_gemm.cu")) as f:
        source = f.read()
    tmp = tempfile.mkdtemp(prefix="xnor_variants_")
    procs = {}
    for name, subs in variants.items():
        src = source
        if isinstance(subs, str):   # a whole source file
            with open(subs) as f:
                src = f.read()
            subs = []
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
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} does not build:\n{log}")
        print(json.dumps({"variant": name, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]}), flush=True)
        lib = ctypes.CDLL(so)
        for kernel, symbol in SYMBOLS.items():
            fn = getattr(lib, symbol)
            fn.argtypes = _kernels.SIGNATURES["xnor_gemm.cu"][symbol]
            fn.restype = ctypes.c_int
        libs[name] = lib

    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    plain = {"xnor": xg.xnor_gemm_plain, "xnor_sign": xg.xnor_sign_plain,
             "xnor_affine": xg.xnor_affine_plain}
    cases = []
    for kernel, m, k, n, bn, sp in CASES:
        wp, _, _ = xg.prepack_weights(cs._pm1(gen, k, n).to(device))
        vecs = () if kernel == "xnor" else tuple(
            v.to(device) for v in cs._affine_vectors(gen, n))
        xs = (cs._pm1(gen, m, k).to(device), cs._raw_x(gen, m, k).to(device))
        cases.append((kernel, m, k, n, bn, sp, wp, vecs, xs))

    def call(lib, kernel, x, wp, k, n, vecs, bn, sp, rule):
        m = x.shape[0]
        out = torch.empty((m, n), dtype=torch.float32, device=device)
        _, share = _kernels.xnor_tiling(m, k, n, bn, sp)
        err = getattr(lib, SYMBOLS[kernel])(
            x.data_ptr(), wp.data_ptr(), *(v.data_ptr() for v in vecs),
            out.data_ptr(), m, n, k, wp.shape[1], bn, share, rule,
            torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out

    for rep in range(2):
        for name, lib in libs.items():
            row = {"variant": name, "rep": rep}
            for kernel, m, k, n, bn, sp, wp, vecs, (x, xr) in cases:
                if not name.startswith("x"):
                    for rule, xx in ((_kernels.PACK_GT0, x),
                                     (_kernels.PACK_GT0, xr),
                                     (_kernels.PACK_GE0, xr)):
                        got = call(lib, kernel, xx, wp, k, n, vecs, bn, sp,
                                   rule)
                        bits = _sign_pm1(xx) if rule else xx
                        want = plain[kernel](pack_bits(bits), wp, k,
                                             *vecs)[:, :n]
                        if not torch.equal(got, want):
                            raise AssertionError(
                                f"{name} {kernel} {(m, k, n, bn)} rule "
                                f"{rule}: differs from its plain version")
                share = _kernels.xnor_tiling(m, k, n, bn, sp)[1]
                row[f"{kernel}:{m}x{k}x{n}:bn{bn}:c{share}"] = cs._graph_ms(
                    lambda: call(lib, kernel, x, wp, k, n, vecs, bn, sp,
                                 _kernels.PACK_GT0)) * 1e3
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
