"""Directory-tree datasets for training (flow_from_directory equivalent).

The port's own copy of ``hse_facerec_tf_tpu/train/data.py``. The reference trains from directory-per-class trees via Keras
``ImageDataGenerator.flow_from_directory`` (``facerec_keras_train.py:173-181``)
and from IMDB-wiki age/gender dir layouts (``age_gender_train.py:139-159``).
This loader walks the same layouts, decodes on host threads, and yields fixed
(batch, H, W, 3) float32 arrays ready for the train step (augmentation
happens on the device — train/augment.py).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from ..utils.image_io import get_files, imread_rgb


class DirectoryDataset:
    """Directory-per-class image dataset with label encoding."""

    def __init__(self, root: str, image_size: Tuple[int, int] = (224, 224),
                 normalization: str = "tf", class_to_label=None):
        import cv2

        self.root = root
        self.image_size = image_size
        self.normalization = normalization
        pairs = get_files(root)
        classes = sorted({d for d, _ in pairs})
        self.class_names = classes
        if class_to_label is None:
            class_to_label = {c: i for i, c in enumerate(classes)}
        self.labels = np.array([class_to_label[d] for d, _ in pairs])
        self.paths = [os.path.join(root, f) for _, f in pairs]
        self.n_classes = len(class_to_label)
        self._cv2 = cv2

    def __len__(self):
        return len(self.paths)

    def _load(self, i: int) -> np.ndarray:
        img = imread_rgb(self.paths[i])
        img = self._cv2.resize(img, (self.image_size[1], self.image_size[0]))
        x = img.astype(np.float32)
        if self.normalization == "tf":
            x = x / 127.5 - 1.0
        elif self.normalization == "caffe":
            x = x[..., ::-1] - np.array([103.939, 116.779, 123.68], np.float32)
        elif self.normalization == "vggface2":
            x = x[..., ::-1] - np.array([91.4953, 103.8827, 131.0912], np.float32)
        return x

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                epochs: Optional[int] = None, drop_remainder: bool = True,
                prefetch: int = 2) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (images, labels) with a background decode thread."""
        rng = np.random.RandomState(seed)
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Bounded-wait q.put that re-checks ``stop`` — a plain q.put
            blocks forever on a full queue once the consumer is gone,
            permanently leaking this thread and its decoded batches."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            import sys

            epoch = 0
            try:
                while not stop.is_set() and (epochs is None or epoch < epochs):
                    order = rng.permutation(len(self)) if shuffle else np.arange(len(self))
                    end = len(order) - (len(order) % batch_size if drop_remainder else 0)
                    for s in range(0, end, batch_size):
                        if stop.is_set():
                            return
                        # fill to the intended batch length even across corrupt
                        # files: every step sees the same batch shape
                        target = len(order[s:s + batch_size])
                        pending = list(order[s:s + batch_size])
                        imgs, labels = [], []
                        attempts = 0
                        while pending and attempts < target + 3 * batch_size:
                            i = pending.pop(0)
                            attempts += 1
                            try:
                                imgs.append(self._load(i))
                                labels.append(self.labels[i])
                            except Exception as e:  # corrupt file: warn, refill
                                print(f"warning: skipping unreadable "
                                      f"{self.paths[i]}: {e}", file=sys.stderr)
                                pending.append(int(rng.randint(0, len(self))))
                        n_loaded = len(imgs)
                        while imgs and len(imgs) < target:  # pathological tail
                            j = len(imgs) % n_loaded  # cycle the loaded ones
                            imgs.append(imgs[j])
                            labels.append(labels[j])
                        if imgs and not put((np.stack(imgs), np.asarray(labels))):
                            return
                    epoch += 1
            except Exception as e:  # unexpected: surface to the consumer
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def age_label_from_dirname(dirname: str) -> Optional[int]:
    """IMDB-wiki-style age directories: the dir name is the age in years
    (reference ``age_gender_train.py:139-148``)."""
    try:
        age = int(dirname)
        return age if 0 <= age <= 99 else None
    except ValueError:
        return None


GENDER_DIRNAMES = {"male": 1.0, "female": 0.0, "m": 1.0, "f": 0.0}


def gender_label_from_dirname(dirname: str) -> Optional[float]:
    return GENDER_DIRNAMES.get(dirname.lower())


class LabeledDirDataset(DirectoryDataset):
    """Directory dataset whose labels come from a dirname→label function
    (age-in-years dirs, male/female dirs — the multi-task training layouts)."""

    def __init__(self, root: str, label_fn, **kwargs):
        super().__init__(root, **kwargs)
        labels, keep = [], []
        for i, p in enumerate(self.paths):
            d = os.path.basename(os.path.dirname(p))
            l = label_fn(d)
            if l is not None:
                labels.append(l)
                keep.append(i)
        self.paths = [self.paths[i] for i in keep]
        self.labels = np.asarray(labels)
