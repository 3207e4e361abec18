"""Persistent XLA compilation cache.

Compiling the fused path takes seconds per (shape, backend) bucket; the
persistent cache makes every bucket a one-time cost across processes.
Where the cache lives, in order:

  1. JAX_COMPILATION_CACHE_DIR, when set (JAX reads it itself; this
     module then sets no directory of its own);
  2. the cache_dir argument, or the RUSTSASA_CACHE environment variable;
  3. a fixed directory, <checkout>/.jax_cache (a fixed path, because the
     path is part of every cache key).
"""

from __future__ import annotations

import os

_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)

_enabled = False


def enable_persistent_cache(
    cache_dir: str | None = None, *, library_call: bool = False
) -> None:
    """Idempotently enable the on-disk compilation cache.

    library_call=True marks a call made as a side effect of a library
    API (engine entry points).  Those must not mutate process-global JAX
    config under an embedding application that didn't ask for it — the
    cache dir redirect and jax_include_full_tracebacks_in_locations
    would leak into the host app's own JAX diagnostics.  Library-side
    calls therefore only act when the user opted in by setting the
    RUSTSASA_CACHE env var (or by calling this function directly /
    running one of our entry points first — it is idempotent).
    """
    global _enabled
    if _enabled:
        return
    if library_call and not os.environ.get("RUSTSASA_CACHE"):
        return
    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        path = None  # JAX already uses it
    elif jax.config.jax_compilation_cache_dir:
        # An embedding application already configured a cache;
        # respect it rather than redirecting compiles to ours.
        _enabled = True
        return
    else:
        path = cache_dir or os.environ.get("RUSTSASA_CACHE", _DEFAULT_DIR)
    try:
        if path is not None:
            try:
                os.makedirs(path, exist_ok=True)
                writable = os.access(path, os.W_OK)
            except OSError:
                writable = False
            if not writable:
                # Shared/read-only install (e.g. root-owned site-packages):
                # fall back to a per-user cache instead of failing silently
                # or polluting the install tree.
                path = os.path.join(
                    os.path.expanduser("~"), ".cache", "rustsasa_jax",
                    "jax_cache",
                )
                os.makedirs(path, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
        # Pallas kernels carry their serialized IR, source locations
        # included, inside the custom call, where the cache key's
        # debug-info stripping cannot reach.  With full tracebacks in
        # locations, every distinct call site - and every edit that
        # shifts a caller's lines - would change the key.
        jax.config.update("jax_include_full_tracebacks_in_locations", False)
        _enabled = True
    except Exception:  # noqa: BLE001 - cache is best-effort
        pass
