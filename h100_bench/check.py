"""The comparison that decides ``correct``.

Every answer the window produced is held against the plain reference
(``h100_bench.reference``) for the input it was given. The numbers
compared, each beside its limit from the cell's traffic file:

* ``feature_err``: the widest gap between a served feature and the
  reference's float64 value, over every answer, as a share of that
  feature's largest magnitude in the reference (so a feature near 0, such
  as the correlation of a random texture, is judged on its own scale);
* ``missing``: answers that were due and never came (limit 0);
* ``failed``: calls that raised (limit 0).

``control`` puts the control in the program's place: the same reference one
precision lower (float32 features), computed for the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from h100_bench.reference import expected_features

__all__ = ["compare", "reference"]


def compare(answers, expected, control=None) -> float:
    """``feature_err`` of ``answers`` [(key, array)] against ``expected``
    {key: float64 array}; with ``control`` {key: array}, the control's
    answer for each key is judged in place of the program's."""
    ref = np.stack([expected[k] for k in sorted(expected)])
    scale = np.abs(ref).reshape(-1, ref.shape[-1]).max(axis=0)
    scale = np.maximum(scale, np.finfo(np.float64).tiny)
    worst = 0.0
    for key, got in answers:
        if control is not None:
            got = control[key]
        gap = np.abs(np.asarray(got, np.float64) - expected[key]) / scale
        if gap.size:
            worst = max(worst, float(np.nan_to_num(gap, nan=np.inf).max()))
    return worst


def reference(images: dict, cfg: dict, device, dtype=torch.float64) -> dict:
    """{key: array} of the reference's features for each image tensor in
    ``images`` ({key: (H, W) tensor} or {key: (B, H, W) tensor})."""
    out = {}
    for key, img in images.items():
        x = img.to(device)
        if x.ndim == 3:
            val = torch.stack([expected_features(im, cfg, dtype) for im in x])
        else:
            val = expected_features(x, cfg, dtype)
        out[key] = val.cpu().numpy().astype(np.float64)
    return out
