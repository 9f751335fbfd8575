"""Paths of the shipped reference weights (same as the JAX package's zoo)."""

from __future__ import annotations

import os

REFERENCE_ROOT = "/root/reference"
MTCNN_PB = os.path.join(REFERENCE_ROOT, "age_gender_identity", "mtcnn.pb")
AGEGENDER_PB = os.path.join(REFERENCE_ROOT, "age_gender_identity",
                            "age_gender_tf2_new-01-0.14-0.92_quantized.pb")
