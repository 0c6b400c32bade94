"""Analytic FLOPs accounting and MFU — chip peaks and model-FLOPs
estimates for the step telemetry (the JAX package's ``obs/flops.py``).

Convention, as JAX's: training FLOPs per step = 3 x forward-GEMM FLOPs
(fwd = 2*MACs; the backward costs ~2x fwd for the dL/dW and dL/dx GEMMs
per layer) — the standard MFU numerator, which leaves out optimizer and
elementwise work. The per-program cost ledger (obs/costs) counts what
one run of a program does with ``FlopCounterMode``, and the two agreeing
within a small factor is a tested reconciliation invariant.

Peaks are the H100 SXM spec sheet's dense rates, each beside the card
the port runs on ("NVIDIA H100 80GB HBM3, 700.00 W"): bf16 989.4
TFLOP/s, int8 twice that. A card capped below 700 W runs slower under
load than its peak says; the MFU is against the spec sheet all the same.
"""

from __future__ import annotations

import copy
import logging
from typing import Any, Iterable, Optional, Tuple

log = logging.getLogger(__name__)

# Dense bf16 tensor-core peak (FLOP/s) by device name substring, most
# specific first: the H100 SXM5 spec sheet (989.4 TFLOP/s without
# sparsity), for "NVIDIA H100 80GB HBM3, 700.00 W".
PEAKS_BF16: Tuple[Tuple[str, float], ...] = (
    ("h100", 989.4e12),
)

# int8 tensor-core peak relative to bf16: 2x on the H100 (1,978.9 TOP/s
# dense on its spec sheet).
INT8_MULT: Tuple[Tuple[str, float], ...] = (
    ("h100", 2.0),
)

# Nominal dense peak for hosts with no spec-sheet entry (CPU runs,
# unknown cards): ~100 GFLOP/s, a round order of magnitude for a few
# vectorized cores. MFU against it is a *relative* utilization signal
# only — telemetry marks it peak_precision="nominal" so a reader never
# mistakes a CPU number for a card's.
NOMINAL_HOST_PEAK = 1e11


def _device_kind(device: Any) -> str:
    """The device's name, lower case: a CUDA device's card name, or the
    string given (a name read from a manifest)."""
    import torch

    if isinstance(device, torch.device) and device.type == "cuda":
        return torch.cuda.get_device_name(device).lower()
    return str(getattr(device, "device_kind", "") or device).lower()


def chip_peak_bf16(device: Any) -> Optional[float]:
    kind = _device_kind(device)
    for sub, peak in PEAKS_BF16:
        if sub in kind:
            return peak
    return None


def chip_peak(device: Any, backend: str = "bf16") -> Tuple[Optional[float], str]:
    """Precision-matched peak for MFU accounting (JAX's rule): the int8
    peak for the int8 backend, the dense bf16 peak for everything else
    (the xnor and pallas_xnor backends' popcount kernels are still scored
    against the bf16 peak — the machine's dense capability they compete
    with). Returns (peak or None, precision)."""
    peak = chip_peak_bf16(device)
    if peak is None:
        return None, "unknown"
    if backend == "int8":
        kind = _device_kind(device)
        mult = next((m for sub, m in INT8_MULT if sub in kind), 1.0)
        return peak * mult, "int8"
    return peak, "bf16"


def device_peak_flops(
    device: Any, backend: str = "bf16",
) -> Tuple[float, str]:
    """``chip_peak`` with a nominal-host fallback so step telemetry can
    always report an MFU estimate (marked "nominal" off the spec table —
    see NOMINAL_HOST_PEAK)."""
    peak, precision = chip_peak(device, backend)
    if peak is None:
        return NOMINAL_HOST_PEAK, "nominal"
    return peak, precision


def _tensors(params: Any) -> Iterable:
    if hasattr(params, "parameters"):
        return params.parameters()
    if isinstance(params, dict):
        return params.values()
    return params


def dense_macs_per_example(params: Any) -> int:
    """Analytic per-example MAC count of every dense kernel in the model
    (a module's, a dict's or an iterable's rank-2 tensors contribute
    in*out MACs per example). Exact for the MLP families, where all
    FLOPs are in dense layers."""
    total = 0
    for leaf in _tensors(params):
        if getattr(leaf, "ndim", 0) == 2:
            total += int(leaf.shape[0]) * int(leaf.shape[1])
    return total


def module_macs_per_example(model: Any, input_shape) -> int:
    """Conv + dense MAC count of one forward pass at batch 1, counted
    with ``torch.utils.flop_counter.FlopCounterMode`` (2 FLOPs a MAC for
    its matmuls and convolutions) on a CPU copy of ``model`` in eval mode
    — the conv-family counterpart of ``dense_macs_per_example`` (the JAX
    package walks the jaxpr for the same primitives). ``input_shape`` is
    one example's (e.g. (28, 28, 1))."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    twin = copy.deepcopy(model).to("cpu").eval()
    x = torch.zeros((1, *input_shape), dtype=torch.float32)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        twin(x)
    return int(counter.get_total_flops()) // 2


def train_step_flops(
    model_name: str,
    model: Any,
    batch_size: int,
    *,
    input_shape=None,
) -> Tuple[Optional[float], str]:
    """FLOPs of one optimizer step over ``batch_size`` examples, with the
    estimation method used: "analytic_3x_dense_gemms" for the MLP/QNN
    families (all FLOPs in rank-2 kernels), else
    "analytic_3x_conv_and_dense_from_flop_counter" when ``input_shape``
    is given and the forward can be counted, else (None,
    "unavailable")."""
    if "mlp" in model_name or "qnn" in model_name:
        macs = dense_macs_per_example(model)
        if macs > 0:
            return 3.0 * 2.0 * macs * batch_size, "analytic_3x_dense_gemms"
    if input_shape and hasattr(model, "forward"):
        try:
            macs = module_macs_per_example(model, input_shape)
            if macs > 0:
                return (
                    3.0 * 2.0 * macs * batch_size,
                    "analytic_3x_conv_and_dense_from_flop_counter",
                )
        except Exception as e:
            # A model whose forward cannot run at batch 1 on the CPU
            # simply gets no MFU figure.
            log.debug("FLOP count failed (%s); flops unavailable", e)
    return None, "unavailable"


def mfu(
    step_flops: Optional[float],
    step_time_s: Optional[float],
    peak: Optional[float],
    n_devices: int = 1,
) -> Optional[float]:
    """Model FLOPs Utilization: achieved model FLOPs/s over the peak of
    the ``n_devices`` cards the step ran on."""
    if not step_flops or not step_time_s or not peak or step_time_s <= 0:
        return None
    return round(step_flops / step_time_s / (peak * max(n_devices, 1)), 6)


def _live_cpu_tensors() -> dict:
    """The CPU census: every live torch tensor's storage bytes, each
    storage counted once (``gc`` walk)."""
    import gc
    import warnings

    import torch

    seen, total, n = set(), 0, 0
    with warnings.catch_warnings():
        # isinstance on some module objects warns of deprecated names
        warnings.simplefilter("ignore")
        tensors = [o for o in gc.get_objects()
                   if isinstance(o, torch.Tensor)]
    for obj in tensors:
        try:
            if obj.is_cuda:
                continue
            storage = obj.untyped_storage()
            key = storage.data_ptr()
            if key in seen or storage.nbytes() == 0:
                continue
            seen.add(key)
            total += int(storage.nbytes())
            n += 1
        except (RuntimeError, ReferenceError, TypeError):
            continue
    return {"0": {"bytes_in_use": total, "live_buffers": n,
                  "source": "live_arrays"}} if n else {}


def device_memory_stats(
    *, live_fallback: bool = False,
) -> Optional[dict]:
    """Per-card memory use under the JAX package's keys: {device index:
    {bytes_in_use, peak_bytes_in_use, bytes_limit}} from
    ``torch.cuda.memory_stats`` (the caching allocator's live and peak
    bytes) and ``torch.cuda.mem_get_info`` (the card's total), for every
    card this process has used; None without a card.

    ``live_fallback=True`` adds the CPU census when there is no card:
    the bytes of every live tensor's storage (a ``gc`` walk, marked
    ``source="live_arrays"``) — O(live objects), for poll-rate paths
    (/healthz), never the step loop."""
    import torch

    try:
        out = {}
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                if not torch.cuda.memory_reserved(i):
                    continue      # a card this process never touched
                stats = torch.cuda.memory_stats(i)
                out[str(i)] = {
                    "bytes_in_use": int(stats.get(
                        "allocated_bytes.all.current", 0)),
                    "peak_bytes_in_use": int(stats.get(
                        "allocated_bytes.all.peak", 0)),
                    "bytes_limit": int(torch.cuda.mem_get_info(i)[1]),
                }
        if out or not live_fallback:
            return out or None
        return _live_cpu_tensors() or None
    except (RuntimeError, TypeError, ValueError):
        return None
