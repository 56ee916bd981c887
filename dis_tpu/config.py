"""Configuration for the DIS optical flow engine.

The ten "compat core" parameters mirror the reference CLI
(``/root/reference/src/main.cpp:63-101``); derived quantities follow
``/root/reference/src/optical_flow.cpp:33-59``.  New knobs (``mode``,
``refinement``, sampler/kernel selection) are additions of this build.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DISConfig:
    """Parameters of the DIS pipeline.

    Compat-core parameters (reference ``main.cpp:63-72`` defaults):

    - ``iterations``: max IC-LK iterations per patch (ref default 1000).
    - ``patch_size``: square patch side in pixels.
    - ``coarsest_scale`` / ``finest_scale``: pyramid range (scale s has
      dimensions ``/2**s``).
    - ``patch_overlap``: fraction of patch overlap; patch stride is
      ``steps = max(1, floor(patch_size * (1 - patch_overlap)))``
      (ref ``optical_flow.cpp:38``).
    - ``patch_normalization``: mean-subtract the warped query patch
      (ref ``patch.cpp:264-266``).

    Additions of this build:

    - ``mode``: ``"compat"`` reproduces the reference's quirk ledger
      (SURVEY.md Q1-Q10) for EPE-parity scoring; ``"fixed"`` applies the
      true IC-LK residual (subtracts the template), adds a per-patch
      convergence test, and residual-adaptive densification weights
      (closer to the DIS paper).
    - ``refinement_iters``: variational refinement fixed-point iterations
      (0 disables; the reference skips this paper step entirely,
      ``README.md:11``).
    - ``early_exit``: allow the XLA search to stop once every patch
      has converged (``lax.while_loop``); only meaningful in fixed mode
      or when policing freezes all patches. Compat output is unaffected
      because frozen patches are masked either way.  The GPU search
      kernel always stops per block of patches (output-identical).
    - ``conv_eps``: fixed-mode convergence threshold on ``|delta_u|``.
    """

    iterations: int = 1000
    patch_size: int = 8
    coarsest_scale: int = 3
    finest_scale: int = 0
    patch_overlap: float = 0.7
    patch_normalization: bool = True

    mode: str = "compat"  # "compat" | "fixed"
    # XLA search sampler: "region" (per-patch regions + one-hot
    # contractions) | "global" (reference-shaped direct gather)
    sampler: str = "region"
    # IC-LK search: "auto" (dis_tpu/backend.py decides per platform) |
    # "pallas" (fused Pallas-Triton kernel, GPU only) | "xla"
    kernel: str = "auto"
    refinement_iters: int = 0
    refinement_alpha: float = 10.0
    refinement_delta: float = 5.0
    refinement_gamma: float = 10.0
    # DIS paper sec. 3.3 refines at EVERY pyramid level (the refined
    # flow seeds the next-finer scale); False refines only once at the
    # finest scale.  Compat mode is unaffected either way (the reference
    # skips refinement entirely, README.md:11).
    refine_per_level: bool = False
    # Red-black Gauss-Seidel sweeps per IRLS outer iteration.
    refinement_inner_sweeps: int = 5
    # Relaxation sweeps per robust-weight update (lagged-diffusivity
    # blocking): K>1 reuses one weights/system assembly for K sweeps,
    # trading slightly staler weights for cheaper sweeps.
    refinement_sor_sweeps: int = 1
    # Red-black successive over-relaxation factor (1.0 = plain
    # Gauss-Seidel).  The DIS authors' refinement (OpenCV
    # VariationalRefinement) uses 1.6; >1 accelerates the linear solve
    # so fewer sweeps reach the same fixed point.
    refinement_omega: float = 1.0
    # Linearization scheme per outer warp:
    #   "planes6" — warp I2 and its five derivative planes with one
    #               shared gather (Brox-exact: derivatives OF I2,
    #               sampled at x+u).
    #   "warp1"   — warp only I2, then Sobel the warped image and
    #               average with I1's gradients (gradient averaging, the
    #               structure of the DIS authors' own OpenCV
    #               VariationalRefinement).  1/6th the gather work.
    refinement_scheme: str = "planes6"
    # Which image planes the refinement's data term reads:
    #   "q1"        — the pipeline's gradient-magnitude pyramid levels
    #                 (quirk Q1, main.cpp:18-29), consistent with what
    #                 the patch search matched.
    #   "intensity" — an OpenCV-resize chain of the RAW input image
    #                 (what the DIS paper's refinement actually uses).
    #                 The magnitude image turns step edges into thin
    #                 ridges whose subpixel bilinear data term is poorly
    #                 conditioned, biasing flow across the edge; the
    #                 intensity data term does not.  Intensity planes
    #                 carry ~4x the dynamic range of the magnitude
    #                 levels, so the data term strengthens and alpha
    #                 must scale up with them: measured on the 7
    #                 synthetic families (384x512, DIS_MEDIUM),
    #                 q1/alpha=10 mean EPE 0.0298 (natural_warp 0.0988)
    #                 -> intensity/alpha=40 mean 0.0180 (natural_warp
    #                 0.0525), EVERY family improved; alpha=20 gives
    #                 0.0202, alpha=60 0.0182 with smooth_warp worse
    #                 (round-4 VERDICT item #7 sweep,
    #                 tools/quality_sweep.py).
    refinement_planes: str = "q1"
    early_exit: bool = True
    conv_eps: float = 0.01

    def __post_init__(self):
        if self.mode not in ("compat", "fixed"):
            raise ValueError(f"mode must be 'compat' or 'fixed', got {self.mode!r}")
        if self.sampler not in ("region", "global"):
            raise ValueError(f"sampler must be 'region' or 'global', got {self.sampler!r}")
        if self.kernel not in ("auto", "pallas", "xla"):
            raise ValueError(f"kernel must be 'auto', 'pallas' or 'xla', got {self.kernel!r}")
        if self.refinement_scheme not in ("planes6", "warp1"):
            raise ValueError(
                f"refinement_scheme must be 'planes6' or 'warp1', "
                f"got {self.refinement_scheme!r}")
        if self.refinement_planes not in ("q1", "intensity"):
            raise ValueError(
                f"refinement_planes must be 'q1' or 'intensity', "
                f"got {self.refinement_planes!r}")
        if self.patch_size % 2 != 0:
            raise ValueError("patch_size must be even (reference uses ps/2 offsets)")
        if self.finest_scale > self.coarsest_scale:
            raise ValueError("finest_scale must be <= coarsest_scale")

    # -- derived (reference optical_flow.cpp:33-40) ------------------------

    @property
    def steps(self) -> int:
        """Patch-center stride in px (``optical_flow.cpp:38``)."""
        return max(1, int(math.floor(self.patch_size * (1.0 - self.patch_overlap))))

    @property
    def outlier_thresh(self) -> float:
        """Max displacement from the scale's start position (``optical_flow.cpp:34``)."""
        return float(self.patch_size) / 2.0

    @property
    def num_points_patch(self) -> int:
        return self.patch_size * self.patch_size

    @property
    def img_padding(self) -> int:
        """Per-level border padding equals patch_size (``main.cpp:177``)."""
        return self.patch_size

    @property
    def num_scales(self) -> int:
        return self.coarsest_scale - self.finest_scale + 1

    def scale_dims(self, width: int, height: int, scale: int) -> Tuple[int, int]:
        """(w, h) at pyramid scale ``scale`` for padded input dims.

        Matches ``optical_flow.cpp:51-53``: ``dim * 2**-scale`` truncated —
        exact because inputs are pre-padded to be divisible by
        ``2**coarsest_scale`` (``main.cpp:140-155``).
        """
        f = 2.0 ** (-scale)
        return int(width * f), int(height * f)


# Preset family in the spirit of the DIS paper's operating points (the
# reference's own defaults — 1000 iterations, stride 2 — are far off any
# paper preset; see BASELINE.md). Names follow the paper's fast /
# medium / full ladder; "full" enables the variational refinement the
# reference skips.
DIS_ULTRAFAST = DISConfig(
    iterations=12, patch_size=8, coarsest_scale=3, finest_scale=1,
    patch_overlap=0.3, mode="fixed", early_exit=True,
)

DIS_FAST = DISConfig(
    iterations=16, patch_size=8, coarsest_scale=3, finest_scale=0,
    patch_overlap=0.3, patch_normalization=True, mode="fixed",
    early_exit=True,
)

DIS_MEDIUM = DISConfig(
    iterations=16, patch_size=8, coarsest_scale=3, finest_scale=0,
    patch_overlap=0.5, mode="fixed", early_exit=True,
    # Paper-form refinement (OpenCV VariationalRefinement structure,
    # the DIS authors' own implementation): ONE warp/linearization per
    # level, 5 lagged fixed-point weight updates x 5 SOR sweeps,
    # omega=1.6.  Measured better EPE than 5 re-warping outers at 1/5
    # the warp work.
    refinement_iters=1, refine_per_level=True,
    refinement_inner_sweeps=5, refinement_sor_sweeps=5,
    refinement_omega=1.6,
    # Intensity data term + rebalanced smoothness: mean family EPE
    # 0.0298 -> 0.0180 with every family improving (see the
    # refinement_planes field comment; round-4 sweep).
    refinement_planes="intensity", refinement_alpha=40.0,
)

DIS_FULL = DISConfig(
    iterations=64, patch_size=12, coarsest_scale=4, finest_scale=0,
    patch_overlap=0.75, mode="fixed", early_exit=True,
    refinement_iters=1, refine_per_level=True,
    refinement_inner_sweeps=10, refinement_sor_sweeps=5,
    refinement_omega=1.6,
    # Same round-4 sweep as DIS_MEDIUM: mean family EPE 0.0337 ->
    # 0.0183 (natural_warp 0.1096 -> 0.0543), every family improving.
    refinement_planes="intensity", refinement_alpha=40.0,
)

DIS_COMPAT_DEFAULT = DISConfig()

PRESETS = {
    "ultrafast": DIS_ULTRAFAST,
    "fast": DIS_FAST,
    "medium": DIS_MEDIUM,
    "full": DIS_FULL,
    "compat": DIS_COMPAT_DEFAULT,
}
