"""Typed configuration.

The port's own copy of ``hse_facerec_tf_tpu/config.py``: ``DetectorConfig``,
``AnalyzerConfig``, ``AlbumConfig`` (with ``from_file``, the reference's
``config.txt`` format) and ``TrainConfig``, with the same fields and
defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class DetectorConfig:
    """MTCNN cascade constants (reference ``facial_analysis.py:481-483,37``)."""
    minsize: int = 40
    thresholds: Tuple[float, float, float] = (0.6, 0.7, 0.9)
    factor: float = 0.709
    max_level_boxes: int = 384
    max_stage2: int = 128
    max_stage3: int = 64
    # cap-doubling retries detect()/detect_batch() may take when a static
    # budget saturates on a dense crowd (pipelines/detector.py::caps_for)
    max_escalations: int = 2


@dataclasses.dataclass
class AnalyzerConfig:
    face_size: int = 224
    bbox_dilation: int = 10          # reference :242
    male_threshold: float = 0.6      # reference :76-81


@dataclasses.dataclass
class AlbumConfig:
    """Album organizer knobs (reference ``process_photos.py:23-27`` defaults,
    ``config.txt`` keys)."""
    min_days_difference: int = 2
    min_no_photos: int = 2
    min_no_frames: int = 10
    distance_threshold: float = 0.82
    min_face_width_percent: float = 0.05
    input_directory: Optional[str] = None
    age_penalty_weight: float = 0.1  # reference :51
    clustering_method: str = "scipy"
    # the reference album constructs its engine with minsize=112
    # (process_photos.py:385), not the demo default 40, so small
    # background faces never enter the album clustering
    minsize: int = 112

    @classmethod
    def from_file(cls, path: str) -> "AlbumConfig":
        """Parse the reference's ``config.txt`` (ConfigParser DEFAULT section,
        keys per ``process_photos.py:374-383``)."""
        from configparser import ConfigParser

        cp = ConfigParser()
        cp.read(path)
        d = cp["DEFAULT"]
        return cls(
            min_days_difference=int(d.get("MinDaysDifferenceBetweenPhotoMDates", 2)),
            min_no_photos=int(d.get("MinNoPhotos", 2)),
            min_no_frames=int(d.get("MinNoFrames", 10)),
            distance_threshold=float(d.get("DistanceThreshold", 0.82)),
            min_face_width_percent=float(d.get("MinFaceWidthPercent", 5)) / 100.0,
            input_directory=d.get("InputDirectory", None),
        )


@dataclasses.dataclass
class TrainConfig:
    """Training hyperparameters (reference ``facerec_keras_train.py:149-215``,
    ``age_gender_train.py:116-123,240-269``)."""
    batch_size: int = 32
    learning_rate: float = 1e-3
    lr_decay: float = 1e-5
    weight_decay: float = 4e-5
    epochs: int = 16
    early_stopping_patience: int = 2
    image_size: int = 224
    finetune_learning_rate: float = 1e-4
    frozen_epochs: int = 3
    finetune_epochs: int = 30
