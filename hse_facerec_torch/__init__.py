"""PyTorch/CUDA port of the facial-analysis framework (NVIDIA H100).

The JAX package ``hse_facerec_tf_tpu`` is the reference: every module here
keeps its counterpart's name and is held against it by
``tests/test_torch_*.py``. Hand-written CUDA kernels live in ``csrc/`` and
are built with ``nvcc`` at first use (``ops/kernels/build.py``).

Quick start::

    from hse_facerec_torch import FacialAnalyzer, zoo
    analyzer = FacialAnalyzer.from_reference_models(
        zoo.MTCNN_PB, zoo.AGEGENDER_PB, device="cuda")
    faces = analyzer.analyze(rgb_image)           # detect + age/gender/identity

Every forward takes the reference's ``precision`` tier ("highest", IEEE
fp32, by default; "high" and "default" run TF32) and holds it itself
(``numerics.precision_scope``): no global setting changes an answer.
"""

__version__ = "0.1.0"

from .numerics import set_parity_numerics


def __getattr__(name):
    # lazy imports keep `import hse_facerec_torch` light
    if name == "FacialAnalyzer":
        from .pipelines.analyzer import FacialAnalyzer

        return FacialAnalyzer
    if name == "MTCNNDetector":
        from .pipelines.detector import MTCNNDetector

        return MTCNNDetector
    if name == "FaceIdTrainer":
        from .train.face_id import FaceIdTrainer

        return FaceIdTrainer
    if name == "zoo":
        from .models import zoo

        return zoo
    raise AttributeError(name)
