"""Command-line interface of the port.

  analyze — detect faces in one image and print age, gender and box per face

Usage: ``python -m hse_facerec_torch.cli analyze IMAGE [--out annotated.jpg]``
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _build_analyzer(args):
    from .models import zoo
    from .pipelines.analyzer import FacialAnalyzer

    mtcnn_pb = args.mtcnn_pb or zoo.MTCNN_PB
    agegender_pb = args.agegender_pb or zoo.AGEGENDER_PB
    for path in (mtcnn_pb, agegender_pb):
        if not os.path.exists(path):
            sys.exit(f"error: weights not found: {path}")
    return FacialAnalyzer.from_reference_models(
        mtcnn_pb, agegender_pb, device=args.device, minsize=args.minsize)


def cmd_analyze(args):
    import cv2
    import numpy as np

    from hse_facerec_tf_tpu.utils.draw import draw_faces
    from hse_facerec_tf_tpu.utils.image_io import imread_rgb

    from .numerics import set_parity_numerics

    if not os.path.exists(args.image):
        sys.exit(f"error: image not found: {args.image}")
    set_parity_numerics()
    analyzer = _build_analyzer(args)
    img = imread_rgb(args.image)
    faces, rotation = analyzer.analyze_with_rotations(img)
    for f in faces:
        print(json.dumps({
            "bbox": list(f.bbox), "score": round(f.score, 4),
            "age": round(f.age, 1), "gender_prob": round(f.gender_prob, 4),
            "is_male": bool(f.is_male()),
        }))
    if args.out:
        if rotation:
            # boxes are in rotated-image coordinates; draw on that orientation
            img = np.ascontiguousarray(np.rot90(img, 3 if rotation == 90 else 1))
        annotated = draw_faces(img, faces)
        cv2.imwrite(args.out, cv2.cvtColor(annotated, cv2.COLOR_RGB2BGR))
        print(f"annotated -> {args.out}", file=sys.stderr)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="hse_facerec_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("analyze", help="annotate one image")
    p.add_argument("image")
    p.add_argument("--out", default=None, help="write the annotated image here")
    p.add_argument("--device", default="cuda")
    p.add_argument("--mtcnn-pb", default=None)
    p.add_argument("--agegender-pb", default=None)
    p.add_argument("--minsize", type=int, default=40)
    p.set_defaults(fn=cmd_analyze)
    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
