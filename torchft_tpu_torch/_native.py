"""ctypes bindings for the native coordination core.

The same framework-neutral C++ library the JAX package loads
(``native/``: lighthouse, manager server, store, fragment server, host
codec).  If the library is missing it is built on first use from the
sources in ``native/``, with this module's own ``CXXFLAGS`` on make's
command line: a newer g++ than the one the Makefile was written against
must not fail the build on a new warning (the Makefile's default adds
``-Werror``).  It also names the compiler, ``g++`` from ``PATH``, instead of
inheriting ``CXX`` from the environment: the library must use the same
shared libstdc++ that PyTorch loads.  A toolchain that links its own
libstdc++ into the library (as the ``CXX`` exported on the H100 machine
does) leaves two copies of ``std::locale`` in one process once torch is
imported, and the first ``ostringstream << long`` in a server thread
crashes.

Several processes may find the library missing at once: the build runs
under an ``fcntl.flock`` on ``native/libtorchft_tpu_native.so.lock``,
staleness is checked again once the lock is held, and make links a
temporary name of this process's own that ``os.replace`` moves into place
(``utils/buildlock.py``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
_LIB_NAME = "libtorchft_tpu_native.so"

_build_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None

# Signature of a lighthouse /metrics supplement provider: writes exposition
# text into (buf, cap); returns bytes written, or the negated required size
# when cap is too small.  Called from native HTTP threads — ctypes acquires
# the GIL around the Python callable automatically.
METRICS_PROVIDER_CFUNC = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.POINTER(ctypes.c_char), ctypes.c_int
)

# Signature of the distributed-tracing span sink: receives one finished
# native span as a JSON C string (tracing.py forwards it to the Python
# exporter).  Called from native RPC handler threads — ctypes acquires
# the GIL around the Python callable automatically.
SPAN_SINK_CFUNC = ctypes.CFUNCTYPE(None, ctypes.c_char_p)


def loaded() -> bool:
    """True when the native library has already been loaded in this
    process — lets optional wiring (the tracing span sink) avoid
    triggering a native build as an import side effect."""
    return _lib is not None


# The Makefile's flags minus -Werror (native/Makefile keeps its own).
_CXXFLAGS = "-O2 -g -std=c++17 -fPIC -Wall -Wextra -pthread"


def _build(out: str) -> None:
    """Run make in ``native/`` with the library linked to ``out`` (a name
    in ``native/``)."""
    cmd = [
        "make", "-C", _NATIVE_DIR, "-j", str(os.cpu_count() or 2),
        "CXX=g++", f"CXXFLAGS={_CXXFLAGS}",
        f"LIB={os.path.basename(out)}",
    ]
    result = subprocess.run(cmd, capture_output=True, text=True)
    if result.returncode != 0:
        raise RuntimeError(
            f"native build failed:\n{result.stdout}\n{result.stderr}"
        )


def _stale(lib_path: str) -> bool:
    """True when any native source/Makefile is newer than the built .so."""
    try:
        built = os.path.getmtime(lib_path)
        for name in os.listdir(_NATIVE_DIR):
            if name == "smoke.cc":
                # sanitizer smoke driver: not linked into the .so, so a
                # newer copy must not make the lib look perpetually stale
                # (make would no-op and never advance the .so mtime)
                continue
            if name.endswith((".cc", ".h")) or name == "Makefile":
                if os.path.getmtime(os.path.join(_NATIVE_DIR, name)) > built:
                    return True
    except OSError:
        return True  # unreadable state: let make decide
    return False


def _find_lib() -> str:
    """Locate (or build) the shared library.  Search order:

    1. ``TORCHFT_NATIVE_LIB`` — explicit override (deployment images);
    2. the repo-layout ``native/`` source tree — editable/dev installs,
       built on first import when missing (g++/make are baked into the
       target environment).  The source tree outranks a staged ``.so``
       so a dev checkout where ``pip wheel .`` once copied a build into
       the package dir never silently shadows later native/ rebuilds;
    3. the packaged ``.so`` next to this module — wheel installs (staged
       by setup.py's build_py hook; no source tree present there).
    """
    from torchft_tpu_torch.utils.env import env_str

    env = env_str("TORCHFT_NATIVE_LIB")
    if env:
        if not os.path.exists(env):
            raise FileNotFoundError(f"TORCHFT_NATIVE_LIB={env} does not exist")
        return env
    if os.path.isdir(_NATIVE_DIR):
        repo = os.path.join(_NATIVE_DIR, _LIB_NAME)
        # rebuild when STALE, not just missing: a pulled source change
        # with a previously built (gitignored) .so would otherwise load a
        # library missing newly bound symbols — ctypes raises
        # AttributeError inside get_lib() and every coordination server
        # hard-fails on functionality unrelated to the new symbols
        from torchft_tpu_torch.utils import buildlock

        buildlock.build_once(
            repo, lambda: not os.path.exists(repo) or _stale(repo), _build
        )
        return repo
    packaged = os.path.join(_PKG_DIR, _LIB_NAME)
    if os.path.exists(packaged):
        return packaged
    raise RuntimeError(
        "native core not found: no packaged .so, no native/ source tree, "
        "and TORCHFT_NATIVE_LIB unset"
    )


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_find_lib())

        lib.tft_last_error.restype = ctypes.c_char_p
        lib.tft_free.argtypes = [ctypes.c_void_p]

        lib.tft_lighthouse_create.restype = ctypes.c_int64
        lib.tft_lighthouse_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            # status plane: status_page_size, straggler_topk, timeline_ring
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            # weight-serving tier: serving_fanout (distribution-tree arity)
            ctypes.c_int64,
            # coordination-plane HA: peers (comma list of the OTHER
            # lighthouse peers; empty = single mode) + lease_timeout_ms
            ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.tft_lighthouse_ha_info.restype = ctypes.c_void_p
        lib.tft_lighthouse_ha_info.argtypes = [ctypes.c_int64]
        lib.tft_manager_create.restype = ctypes.c_int64
        lib.tft_manager_create.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.tft_store_create.restype = ctypes.c_int64
        lib.tft_store_create.argtypes = [ctypes.c_char_p, ctypes.c_int]

        lib.tft_server_address.restype = ctypes.c_void_p
        lib.tft_server_address.argtypes = [ctypes.c_int64]
        lib.tft_server_shutdown.restype = ctypes.c_int
        lib.tft_server_shutdown.argtypes = [ctypes.c_int64]

        lib.tft_lighthouse_set_metrics_provider.restype = ctypes.c_int
        lib.tft_lighthouse_set_metrics_provider.argtypes = [
            ctypes.c_int64, METRICS_PROVIDER_CFUNC,
        ]

        lib.tft_set_span_sink.restype = ctypes.c_int
        lib.tft_set_span_sink.argtypes = [SPAN_SINK_CFUNC]

        lib.tft_manager_report_progress.restype = ctypes.c_int
        lib.tft_manager_report_progress.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
        ]

        lib.tft_manager_report_summary.restype = ctypes.c_int
        lib.tft_manager_report_summary.argtypes = [
            ctypes.c_int64, ctypes.c_char_p,
        ]

        lib.tft_manager_report_links.restype = ctypes.c_int
        lib.tft_manager_report_links.argtypes = [
            ctypes.c_int64, ctypes.c_char_p,
        ]

        lib.tft_manager_report_fragments.restype = ctypes.c_int
        lib.tft_manager_report_fragments.argtypes = [
            ctypes.c_int64, ctypes.c_char_p,
        ]

        lib.tft_compute_quorum_results.restype = ctypes.c_void_p
        lib.tft_compute_quorum_results.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int,
        ]

        # Fused host codec (native/quant.cc) — GIL-free memory-bandwidth
        # kernels for BOTH DCN wire formats (int8 + fp8_e4m3); bit-exact
        # on finite inputs against the numpy codec in ops/quantization.py
        # (which stays as the reference semantics / fallback).
        _f32p = ctypes.POINTER(ctypes.c_float)
        _i8p = ctypes.POINTER(ctypes.c_int8)
        lib.tft_quant_int8.restype = None
        lib.tft_quant_int8.argtypes = [
            _f32p, ctypes.c_int64, ctypes.c_int64, _f32p, _i8p,
        ]
        lib.tft_dequant_fma.restype = None
        lib.tft_dequant_fma.argtypes = [
            _i8p, _f32p, ctypes.c_int64, ctypes.c_int64, _f32p, ctypes.c_int,
        ]
        _u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.tft_quant_fp8.restype = None
        lib.tft_quant_fp8.argtypes = [
            _f32p, ctypes.c_int64, ctypes.c_int64, _f32p, _u8p,
        ]
        lib.tft_dequant_fp8_fma.restype = None
        lib.tft_dequant_fp8_fma.argtypes = [
            _u8p, _f32p, _f32p, ctypes.c_int64, ctypes.c_int64, _f32p,
            ctypes.c_int,
        ]
        lib.tft_div_f32.restype = None
        lib.tft_div_f32.argtypes = [_f32p, ctypes.c_int64, ctypes.c_float]
        # Row-range entry points: same kernels over [r0, r1) of a shared
        # buffer — the threaded-codec surface (rows are independent, so
        # disjoint ranges are data-race-free; ops/codec_pool.py fans one
        # chunk across these with the GIL released).
        _i64 = ctypes.c_int64
        lib.tft_quant_int8_rows.restype = None
        lib.tft_quant_int8_rows.argtypes = [_f32p, _i64, _i64, _i64, _f32p, _i8p]
        lib.tft_quant_fp8_rows.restype = None
        lib.tft_quant_fp8_rows.argtypes = [_f32p, _i64, _i64, _i64, _f32p, _u8p]
        lib.tft_dequant_fma_rows.restype = None
        lib.tft_dequant_fma_rows.argtypes = [
            _i8p, _f32p, _i64, _i64, _i64, _f32p, ctypes.c_int,
        ]
        lib.tft_dequant_fp8_fma_rows.restype = None
        lib.tft_dequant_fp8_fma_rows.argtypes = [
            _u8p, _f32p, _f32p, _i64, _i64, _i64, _f32p, ctypes.c_int,
        ]
        lib.tft_div_f32_rows.restype = None
        lib.tft_div_f32_rows.argtypes = [_f32p, _i64, _i64, _i64, ctypes.c_float]

        # Native zero-copy fragment data plane (native/fragserver.{h,cc}).
        # Server lifecycle + the staging mirror HTTPTransport drives, and
        # the two-phase GIL-free fetch client fragments.py dispatches to
        # behind the TORCHFT_FRAG_NATIVE gate.
        lib.tft_frag_server_create.restype = ctypes.c_int64
        lib.tft_frag_server_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.tft_frag_server_port.restype = ctypes.c_int
        lib.tft_frag_server_port.argtypes = [ctypes.c_int64]
        lib.tft_frag_begin.restype = ctypes.c_int
        lib.tft_frag_begin.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.tft_frag_stage.restype = ctypes.c_int
        lib.tft_frag_stage.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p, _u8p, _i64,
        ]
        lib.tft_frag_finish.restype = ctypes.c_int
        lib.tft_frag_finish.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.tft_frag_retire.restype = ctypes.c_int
        lib.tft_frag_retire.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.tft_frag_counters.restype = ctypes.c_void_p
        lib.tft_frag_counters.argtypes = [ctypes.c_int64]
        lib.tft_frag_inject.restype = ctypes.c_int
        lib.tft_frag_inject.argtypes = [
            ctypes.c_int64, ctypes.c_char_p, _i64, _i64,
        ]
        lib.tft_frag_fetch_begin.restype = ctypes.c_int
        lib.tft_frag_fetch_begin.argtypes = [
            ctypes.c_char_p, _i64, ctypes.c_char_p, _i64,
            ctypes.POINTER(_i64), ctypes.POINTER(ctypes.c_double),
        ]
        lib.tft_frag_fetch_body.restype = ctypes.c_int
        lib.tft_frag_fetch_body.argtypes = [
            _u8p, _i64, ctypes.c_char_p, _i64,
        ]
        lib.tft_frag_fetch_abort.restype = None
        lib.tft_frag_fetch_abort.argtypes = []
        lib.tft_frag_client_close.restype = None
        lib.tft_frag_client_close.argtypes = []
        lib.tft_frag_client_error.restype = ctypes.c_char_p
        lib.tft_frag_client_error.argtypes = []
        lib.tft_sha256_hex.restype = ctypes.c_int
        lib.tft_sha256_hex.argtypes = [_u8p, _i64, ctypes.c_char_p]
        _lib = lib
        return _lib


def last_error() -> str:
    return get_lib().tft_last_error().decode()


def take_string(ptr: int) -> str:
    """Copy a malloc'd C string into Python and free it."""
    lib = get_lib()
    if not ptr:
        raise RuntimeError(last_error())
    try:
        return ctypes.string_at(ptr).decode()
    finally:
        lib.tft_free(ptr)
