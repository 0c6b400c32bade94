"""Ahead-of-time store of the kernel libraries: boots with no ``nvcc``.

``cli aot build`` builds the libraries of the known programs (classifier
predict, the LM's prefill, decode and verify, the train step) into a
content-addressed store; the servers' and the trainer's boots with
``--aot`` consult it first and install the banked libraries instead of
running ``nvcc`` (``aot_hit`` / ``aot_miss`` / ``aot_bank`` /
``aot_fallback`` events). With the store warm, both servers boot with
zero kernel builds, and their recompile fence holds budget 0 from the
boot on. ``coldstart`` times one boot in a fresh process.
"""

from .store import (  # noqa: F401
    AotKey,
    AotStore,
    TensorSpec,
    canonical_extra,
    default_store_dir,
    device_backend,
    format_avals,
    make_key,
    runtime_version,
    sha256_hex,
)
from .programs import (  # noqa: F401
    KNOWN_PROGRAMS,
    current_code_rev,
    load_or_build_train_step,
    load_packed_aot,
    load_paged_lm_decoder_aot,
)
