"""The one place that knows which platform the program runs on.

Every choice that depends on the platform lives here: which IC-LK
search runs, and which of two bit-identical formulations the template
extraction and the 0.5x resize use.  The rest of the package asks this
module and never calls ``jax.default_backend()`` itself.  Supported
platforms are ``"cpu"`` (tests, development) and ``"gpu"`` (an NVIDIA
H100); any other platform raises instead of silently borrowing one of
their choices.

The module also owns the persistent compile-cache rule the entry points
share (:func:`setup_compile_cache`).
"""

from __future__ import annotations

import dataclasses
import os

import jax

PLATFORMS = ("cpu", "gpu")

# <checkout>/.jax_cache: a fixed path (the cache key includes it, so a
# directory that moves between runs never hits); listed in .gitignore.
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(_CHECKOUT, ".jax_cache")


@dataclasses.dataclass(frozen=True)
class Choices:
    """Per-platform implementation choices.

    - ``search``: ``"pallas"`` runs the fused Pallas-Triton IC-LK kernel
      (ops/pallas/iclk_kernel.py), ``"xla"`` the plain-JAX iteration
      loop (ops/iclk.py).
    - ``templates``: the default template-extraction form of
      ops/iclk.py::extract_templates_grid (all forms are bit-identical).
    - ``resize``: the 2x2-mean form of ops/image.py::resize_half.
    """

    search: str
    templates: str
    resize: str


# Measured on the card (PERF.md Findings, CHANGES.md): the Triton search
# kernel against the XLA loop, and each bit-identical pair of forms.
_CHOICES = {
    "cpu": Choices(search="xla", templates="slices", resize="reshape"),
    "gpu": Choices(search="pallas", templates="slices", resize="window2"),
}


def platform() -> str:
    """The default JAX platform, checked against :data:`PLATFORMS`."""
    p = jax.default_backend()
    if p not in PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {p!r}: dis_tpu runs on "
            f"{' or '.join(PLATFORMS)}")
    return p


def choices(platform_name: str | None = None) -> Choices:
    """Implementation choices for ``platform_name`` (default: the
    platform this process runs on)."""
    p = platform() if platform_name is None else platform_name
    if p not in _CHOICES:
        raise RuntimeError(f"unsupported platform {p!r}")
    return _CHOICES[p]


def search_kernel(kernel: str, platform_name: str | None = None) -> str:
    """Which IC-LK search runs for ``DISConfig.kernel`` on a platform:
    ``"auto"`` follows :func:`choices`; ``"xla"`` is valid everywhere;
    ``"pallas"`` needs the card (the Triton kernel does not compile for
    the CPU, and production code never runs it in interpret mode)."""
    p = platform() if platform_name is None else platform_name
    if kernel == "auto":
        return choices(p).search
    if kernel == "pallas" and p != "gpu":
        raise ValueError(
            f"kernel='pallas' (the Pallas-Triton search) runs only on a "
            f"GPU, not on {p!r}; use kernel='auto' or 'xla'")
    return kernel


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at one fixed directory and
    return it.  ``JAX_COMPILATION_CACHE_DIR``, when set, is used as is
    (JAX reads it itself; nothing else is set here).  Otherwise the
    cache lives in ``<checkout>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
