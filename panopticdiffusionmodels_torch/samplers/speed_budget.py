"""Per-geometry guardrails for the opt-in sampling speed modes.

Own copy of `panopticdiffusionmodels_tpu/samplers/speed_budget.py`: the speed
modes (`sample.accel` forecast-skip, `sample.cfg_interval` limited guidance,
`nnet.gelu_approx`) were deviation-measured per model geometry with the JAX
package, against a budget of <= 2 % relative image deviation and <= 2 %
analog-bit flips from the exact 50-NFE trajectory, then gated at the
distribution level on trained weights (`quality_gate/*/report.json`).
Enabling a mode on a geometry where it exceeded the budget, or where it was
never measured, logs a warning instead of degrading outputs silently.

The table is data about output quality, not a claim about the port's speed.
The recommended configurations it encodes: gelu + accel=0.2 on the 256-res
geometries, gelu only at 512 res, no guidance interval anywhere.
"""
from __future__ import annotations

import logging
from typing import List, Optional

_log = logging.getLogger(__name__)

# Validated ceilings per geometry, keyed by
# (nnet family, embed_dim, depth, enable_panoptic, img_size).
# `max_accel`: the largest forecast-skip tau whose measured deviation stayed
# within budget (None: no accel value is within budget on this geometry);
# `interval_ok` / `gelu_ok`: those modes measured within budget.
_VALIDATED = {
    # ImageNet U-ViT-L/2 and L/4 (the same network at 258 tokens): accel 0.3
    # over budget, 0.2 within; the guidance interval fails the flagship gate
    # (quality_gate/trained_L/report.json).
    ("uvit", 1024, 20, False, 32): dict(max_accel=0.2, interval_ok=False, gelu_ok=True),
    ("uvit", 1024, 20, False, 64): dict(max_accel=0.2, interval_ok=False, gelu_ok=True),
    # Panoptic U-ViT-S/2 at 256 res: accel 0.2 and gelu pass the trained gate;
    # every guidance interval shifts the mask-id distribution
    # (quality_gate/trained_panoptic).
    ("uvit_t2i", 512, 12, True, 32): dict(max_accel=0.2, interval_ok=False, gelu_ok=True),
    # Panoptic S/2 at 512 res: accel fails at any tau
    # (quality_gate/trained_panoptic_512/report.json); only gelu is validated.
    ("uvit_t2i", 512, 12, True, 64): dict(max_accel=None, interval_ok=False, gelu_ok=True),
    # t2i-only S model: shares the image-stream measurements.
    ("uvit_t2i", 512, 12, False, 32): dict(max_accel=0.2, interval_ok=False, gelu_ok=True),
    # Panoptic U-ViT-L: accel 0.2 over budget on the mask stream.
    ("uvit_t2i", 1024, 20, True, 32): dict(max_accel=0.1, interval_ok=False, gelu_ok=True),
}


def _geometry_key(config):
    nnet = config.nnet
    name = nnet.get("name", "")
    family = "uvit_t2i" if name in ("uvit_t2i", "unet_t2i") else "uvit"
    return (
        family,
        int(nnet.get("embed_dim", 0)),
        int(nnet.get("depth", 0)),
        bool(nnet.get("enable_panoptic", False)),
        int(nnet.get("img_size", 0)),
    )


def check_speed_modes(config, log: bool = True) -> List[str]:
    """Validate the config's enabled speed modes against the measured
    per-geometry table; returns (and logs) the warnings."""
    accel = float(config.sample.get("accel", 0.0) or 0.0)
    interval = tuple(config.sample.get("cfg_interval", ()) or ())
    gelu = bool(config.nnet.get("gelu_approx", False))
    if not (accel or interval or gelu):
        return []
    warnings: List[str] = []
    key = _geometry_key(config)
    entry: Optional[dict] = _VALIDATED.get(key)
    label = (f"geometry (family={key[0]}, embed_dim={key[1]}, depth={key[2]}, "
             f"panoptic={key[3]}, img_size={key[4]})")
    if entry is None:
        modes = ", ".join(m for m, on in ((f"accel={accel}", accel),
                                          (f"cfg_interval={interval}", interval),
                                          ("gelu_approx", gelu)) if on)
        warnings.append(
            f"speed modes [{modes}] have NO measured deviation entry for {label} — "
            "outputs may deviate more than the documented ~1%; measure the "
            "deviation before shipping")
    else:
        if accel and (entry["max_accel"] is None or accel > entry["max_accel"] + 1e-9):
            validated = (f"validated ceiling is accel={entry['max_accel']}"
                         if entry["max_accel"] else "no accel value is validated")
            warnings.append(
                f"sample.accel={accel} EXCEEDS the measured deviation budget for {label} "
                f"({validated}) — expect degraded outputs (e.g. 13.4% mask deviation "
                "on the panoptic large model at accel=0.2)")
        if interval and not entry.get("interval_ok", False):
            warnings.append(
                f"sample.cfg_interval={interval} is not validated for {label} — every "
                "sharp-channel gate measurement of a guidance interval FAILs (panoptic "
                "mask-id TV 4.7-10.3x the seed floor; flagship latent TV 36.7x the "
                "25-NFE control). Use gelu_approx + accel instead.")
        if gelu and not entry.get("gelu_ok", False):
            warnings.append(f"nnet.gelu_approx is not validated for {label}")
    if log:
        for w in warnings:
            _log.warning(w)
    return warnings
