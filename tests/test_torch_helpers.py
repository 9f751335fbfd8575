"""The port's small helpers against the JAX package's, on the CPU:
``ops/preprocess.py::preprocess_batch`` (the resize matmuls and the
normalization; float32, one rounding order apart at most, so within
2e-4 on 0-255 values), ``ops/nms.py::nms_numpy`` (host numpy, equal picks
in equal order) and ``eval/lfw.py::load_class_filter`` (equal sets).

The codec-free inputs of ``testing.py``, which feed the port where no
image or video codec is installed: the BMP helpers bit-equal to cv2, and
``BmpAlbumOrganizer`` giving the decoding organizer's album result.
"""

import os

import numpy as np
import pytest
import torch

from hse_facerec_tf_tpu.eval import lfw as jlfw
from hse_facerec_tf_tpu.ops import nms as jnms
from hse_facerec_tf_tpu.ops import preprocess as jpre
from hse_facerec_torch.eval import lfw as tlfw
from hse_facerec_torch.ops import nms as tnms
from hse_facerec_torch.ops import preprocess as tpre
from hse_facerec_torch.testing import (BmpAlbumOrganizer, FrameCapture, bmp_bytes,
                                       decode_bmp, random_mtcnn_params,
                                       random_multihead_params, read_bmp, write_bmp)

PRE_ATOL = 2e-4


@pytest.mark.parametrize("normalization", ["vggface2", "caffe", "mtcnn", "tf", "none"])
@pytest.mark.parametrize("method", ["cv2_linear", "cv2_area", "pil_bilinear"])
def test_preprocess_batch_matches_jax(normalization, method):
    rng = np.random.RandomState(len(normalization) + len(method))
    batch = (rng.rand(3, 57, 71, 3) * 255).astype(np.uint8)
    want = np.asarray(jpre.preprocess_batch(batch, (48, 40), normalization, method))
    got = tpre.preprocess_batch(torch.from_numpy(batch), (48, 40), normalization, method)
    assert got.dtype == torch.float32 and got.shape == (3, 48, 40, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PRE_ATOL)


@pytest.mark.parametrize("normalization,means", [("caffe", tpre.IMAGENET_MEANS_BGR),
                                                 ("vggface2", tpre.VGGFACE2_MEANS_BGR),
                                                 ("vggface1", tpre.VGGFACE1_MEANS_BGR)])
def test_the_means_filled_on_the_device_equal_a_host_tensors(normalization, means):
    """The Caffe-lineage normalizations fill their means in on the input's
    device instead of copying them from the host: the same float32 values,
    so the same result bit for bit."""
    x = torch.from_numpy((np.random.RandomState(3).rand(2, 5, 6, 3) * 255).astype(np.float32))
    want = torch.flip(x, dims=(-1,)) - torch.tensor(means, dtype=torch.float32)
    got = tpre.NORMALIZERS[normalization](x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _clustered_boxes(rng, n):
    centers = rng.uniform(20, 180, (6, 2))
    c = centers[rng.randint(0, 6, n)] + rng.randn(n, 2) * 6
    s = rng.uniform(15, 40, n)
    return np.stack([c[:, 0], c[:, 1], c[:, 0] + s, c[:, 1] + s], 1).astype(np.float32)


@pytest.mark.parametrize("method,threshold", [("union", 0.5), ("union", 0.7),
                                              ("min", 0.7)])
def test_nms_numpy_equals_jax(method, threshold):
    rng = np.random.RandomState(int(threshold * 10))
    boxes = _clustered_boxes(rng, 80)
    scores = rng.rand(80).astype(np.float32)
    got = tnms.nms_numpy(boxes, scores, threshold, method)
    want = jnms.nms_numpy(boxes, scores, threshold, method)
    assert got.dtype == np.int64 and 1 < len(got) < 80
    np.testing.assert_array_equal(got, want)
    empty = tnms.nms_numpy(np.zeros((0, 4), np.float32), np.zeros(0, np.float32), 0.5)
    assert empty.shape == (0,) and empty.dtype == np.int64


def test_load_class_filter_equals_jax(tmp_path):
    path = tmp_path / "lfw_ytf_classes.txt"
    path.write_text("Aaron_Eckhart\n\n  Abdullah_Gul \nAdam_Sandler\n\t\nAaron_Eckhart\n")
    got = tlfw.load_class_filter(str(path))
    assert got == jlfw.load_class_filter(str(path))
    assert got == {"Aaron_Eckhart", "Abdullah_Gul", "Adam_Sandler"}


@pytest.mark.parametrize("shape", [(5, 7, 3), (4, 8, 3), (1, 1, 3)])
def test_bmp_round_trip(shape, tmp_path):
    import cv2

    x = np.random.RandomState(5).randint(0, 256, shape).astype(np.uint8)
    np.testing.assert_array_equal(decode_bmp(bmp_bytes(x)), x)
    path = str(tmp_path / "x.bmp")
    write_bmp(path, x)
    np.testing.assert_array_equal(cv2.imread(path)[:, :, ::-1], x)
    np.testing.assert_array_equal(read_bmp(path), x)
    assert decode_bmp(b"not a bmp") is None


def test_bmp_album_organizer_equals_the_decoding_organizer(tmp_path):
    """``BmpAlbumOrganizer`` (photos through ``read_bmp``, a clip's frames
    served from memory) gives the result ``AlbumOrganizer`` gives on the
    same files decoded by cv2 and the same frames; ``write_outputs=False``
    leaves the album as it was."""
    from hse_facerec_torch.config import AlbumConfig
    from hse_facerec_torch.pipelines.album import AlbumOrganizer
    from hse_facerec_torch.pipelines.analyzer import FacialAnalyzer

    from .test_torch_analyzer import _photo
    from .test_torch_batch import CASES

    for i, seed in enumerate((2, 5, 9)):
        write_bmp(str(tmp_path / f"p{i}.bmp"), _photo(seed))
    write_bmp(str(tmp_path / "z_blank.bmp"), np.zeros_like(_photo(2)))
    (tmp_path / "clip.mp4").write_bytes(b"frames served from memory")
    frames = [np.ascontiguousarray(_photo(2)[:, :, ::-1])] * 8
    mtcnn_seed, _, det_kw, head_batch = CASES["fits"]
    analyzer = FacialAnalyzer(random_mtcnn_params(np.random.RandomState(mtcnn_seed)),
                              random_multihead_params(np.random.RandomState(100)),
                              device="cpu", minsize=20, face_size=64,
                              head_batch=head_batch, **det_kw)
    cfg = AlbumConfig(minsize=20, min_days_difference=0)
    album = sorted(os.listdir(tmp_path))
    got = BmpAlbumOrganizer(analyzer, cfg, analyze_batch=4, clips={"clip.mp4": frames}
                            ).process_album(str(tmp_path), use_cache=False,
                                            write_outputs=False)
    assert sorted(os.listdir(tmp_path)) == album
    decoding = AlbumOrganizer(analyzer, cfg, analyze_batch=4)
    decoding._open_video = lambda path: FrameCapture(frames)
    want = decoding.process_album(str(tmp_path), use_cache=False, write_outputs=False)
    for key in ("n_photos", "n_videos", "n_faces", "clusters", "cluster_genders",
                "cluster_born_years", "cluster_labels"):
        assert got[key] == want[key], key
    assert (got["n_photos"], got["n_videos"]) == (4, 1) and got["n_faces"] > 0
