"""Command-line interface of the port.

  analyze  — detect faces in one image and print age, gender and box per
             face; with ``--gallery`` also the matched enrolled person,
             with ``--int8-heads`` on the int8 serving path
  images   — annotate a directory of images (process_all_images)
  video    — annotate a video file (show_video)
  webcam   — live webcam demo (show_webcam)
  album    — organize a photo/video album by person (process_photos)
  identify — gallery/probe 1-NN identification (tf_train_test_recognition)
  enroll   — bulk-enroll a people directory into a gallery .npz: the
             largest face of each photo (``--mode face``, the default) or
             whole frames of pre-cropped faces (``--mode image``)
  cluster  — clustering-quality benchmark on directory-per-person datasets
  train    — train the face-ID backbone on a directory-per-identity
             dataset (augmentation on the warp kernel)

  utkface  — age/gender benchmark on a UTKFace-style directory, through
             one of the reference's nine backends
  export   — the multi-head model as a frozen pb, a quantized npz, or the
             two-model configuration's age and gender pbs

``analyze``, ``images``, ``video`` and ``webcam`` run the two-model
configuration with ``--age-pb``/``--gender-pb`` (``--sota`` for the
data/prob taps). Every subcommand runs on ``--device cuda`` unless asked
for another. The HTTP server is ``python -m hse_facerec_torch.serve``.

Usage: ``python -m hse_facerec_torch.cli <subcommand> ...``
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
    if args.age_pb and args.gender_pb:
        # two-model configuration (reference age_gender_one_model=False)
        if args.int8_heads:
            raise SystemExit(
                "--int8-heads applies to the single multi-head model only; "
                "it is not available with --age-pb/--gender-pb")
        for path in (mtcnn_pb, args.age_pb, args.gender_pb):
            if not os.path.exists(path):
                sys.exit(f"error: weights not found: {path}")
        return FacialAnalyzer.from_two_model_pbs(
            mtcnn_pb, args.age_pb, args.gender_pb, sota=args.sota,
            device=args.device, minsize=args.minsize, oversample=args.oversample)
    agegender_pb = args.agegender_pb or zoo.AGEGENDER_PB
    for path in (mtcnn_pb, agegender_pb):
        if not os.path.exists(path):
            sys.exit(f"error: weights not found: {path}")
    return FacialAnalyzer.from_reference_models(
        mtcnn_pb, agegender_pb, device=args.device, minsize=args.minsize,
        int8_heads=args.int8_heads, oversample=args.oversample)


def _add_model_args(p, minsize=40):
    p.add_argument("--device", default="cuda")
    p.add_argument("--mtcnn-pb", default=None)
    p.add_argument("--agegender-pb", default=None)
    p.add_argument("--age-pb", default=None,
                   help="separate frozen age graph (two-model configuration)")
    p.add_argument("--gender-pb", default=None,
                   help="separate frozen gender graph (two-model configuration)")
    p.add_argument("--sota", action="store_true",
                   help="use_sota tensor taps (data/prob, softmax gender)")
    p.add_argument("--minsize", type=int, default=minsize)
    p.add_argument("--oversample", action="store_true",
                   help="5-crop oversampling: average age/gender over the "
                        "base crop + four ±10 px diagonal shifts "
                        "(facial_analysis.py:248-253, disabled upstream)")
    p.add_argument("--int8-heads", action="store_true",
                   help="run the per-face multi-head net on the full-int8 "
                        "serving path (int8 activations, pointwise layers "
                        "on the int8 kernel; models/int8_infer.py)")


def _load_gallery(path, device):
    """Open a non-empty EnrollmentGallery .npz or exit with a hint."""
    from .pipelines.gallery import EnrollmentGallery

    gallery = EnrollmentGallery(path=path, device=device)
    if not len(gallery):
        sys.exit(f"error: enrollment gallery {path} is empty or missing "
                 "(create one with the 'enroll' subcommand)")
    return gallery


def _gallery_labeler(args):
    """Optional per-face person-name source for the demo overlays: one
    batched gallery ranking per analyze batch (``--gallery``), or None."""
    if not args.gallery:
        return None
    import numpy as np

    gallery = _load_gallery(args.gallery, args.device)
    threshold = args.match_threshold

    def labeler(faces):
        idents = gallery.identify_many(
            np.stack([np.asarray(f.identity, np.float32) for f in faces]),
            threshold=threshold)
        return [label for label, _, _ in idents]

    return labeler


def _add_gallery_args(p):
    p.add_argument("--gallery", default=None, metavar="NPZ",
                   help="enrollment gallery: name the matched person per "
                        "face (see the 'enroll' subcommand)")
    p.add_argument("--match-threshold", type=float, default=0.82,
                   help="L2 distance below which a face matches an "
                        "enrollment (reference DistanceThreshold, "
                        "process_photos.py:26)")


def cmd_analyze(args):
    import cv2
    import numpy as np

    from .utils.draw import draw_faces
    from .utils.image_io import imread_rgb

    if not os.path.exists(args.image):
        sys.exit(f"error: image not found: {args.image}")
    analyzer = _build_analyzer(args)
    img = imread_rgb(args.image)
    faces, rotation = analyzer.analyze_with_rotations(img)
    idents = None
    if args.gallery and faces:
        gallery = _load_gallery(args.gallery, args.device)
        idents = gallery.identify_many(
            np.stack([np.asarray(f.identity, np.float32) for f in faces]),
            threshold=args.match_threshold)
    for k, f in enumerate(faces):
        row = {
            "bbox": list(f.bbox), "score": round(f.score, 4),
            "age": round(f.age, 1), "gender_prob": round(f.gender_prob, 4),
            "is_male": bool(f.is_male()),
        }
        if idents is not None:
            label, dist, nearest = idents[k]
            row.update(label=label, distance=round(dist, 4), nearest=nearest)
        print(json.dumps(row))
    if args.out:
        if rotation:
            # boxes are in rotated-image coordinates; draw on that orientation
            img = np.ascontiguousarray(np.rot90(img, 3 if rotation == 90 else 1))
        annotated = draw_faces(img, faces)
        cv2.imwrite(args.out, cv2.cvtColor(annotated, cv2.COLOR_RGB2BGR))
        print(f"annotated -> {args.out}", file=sys.stderr)


def cmd_images(args):
    import cv2

    from .pipelines.video import process_image_dir

    analyzer = _build_analyzer(args)
    os.makedirs(args.out_dir, exist_ok=True)
    for name, annotated, faces in process_image_dir(
            analyzer, args.image_dir, labeler=_gallery_labeler(args),
            batch=args.batch):
        out = os.path.join(args.out_dir, name)
        cv2.imwrite(out, cv2.cvtColor(annotated, cv2.COLOR_RGB2BGR))
        print(f"{name}: {len(faces)} faces")


def cmd_video(args):
    import cv2

    from .pipelines.video import annotated_video_frames

    if args.frame_skip < 1:
        sys.exit("error: --frame-skip must be >= 1")
    analyzer = _build_analyzer(args)
    writer = None
    n = 0
    for annotated, faces in annotated_video_frames(
            analyzer, args.video, frame_skip=args.frame_skip,
            batch=args.batch, labeler=_gallery_labeler(args)):
        if args.out and writer is None:
            h, w = annotated.shape[:2]
            # annotated frames are every frame_skip-th source frame: write
            # at the source rate / skip so playback speed is preserved
            cap = cv2.VideoCapture(args.video)
            src_fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
            cap.release()
            fps = max(1.0, (src_fps if src_fps > 0 else 30.0) / args.frame_skip)
            writer = cv2.VideoWriter(args.out, cv2.VideoWriter_fourcc(*"mp4v"),
                                     fps, (w, h))
        if writer is not None:
            writer.write(cv2.cvtColor(annotated, cv2.COLOR_RGB2BGR))
        n += 1
        print(f"frame {n}: {len(faces)} faces", end="\r", file=sys.stderr)
    if writer is not None:
        writer.release()
    print(f"\nprocessed {n} frames", file=sys.stderr)


def cmd_webcam(args):
    """Live webcam demo (reference ``show_webcam``, facial_analysis.py:
    607-617): annotate camera frames in a window; ESC quits."""
    import cv2

    from .pipelines.video import annotated_camera_frames

    analyzer = _build_analyzer(args)
    try:
        for annotated, _ in annotated_camera_frames(
                analyzer, args.camera_index, labeler=_gallery_labeler(args)):
            cv2.imshow("hse_facerec_torch webcam", cv2.cvtColor(
                annotated, cv2.COLOR_RGB2BGR))
            if cv2.waitKey(1) == 27:   # esc to quit (reference :614-615)
                break
    finally:
        cv2.destroyAllWindows()


def cmd_album(args):
    from .config import AlbumConfig
    from .pipelines.album import AlbumOrganizer

    if args.age_pb or args.gender_pb:
        # two-model heads have no identity features (reference
        # process_image sets features=[] there) — clustering needs them
        sys.exit("error: album requires the one-model (multi-head) engine; "
                 "the two-model configuration produces no identity features")
    cfg = AlbumConfig.from_file(args.config) if args.config else AlbumConfig()
    if args.threshold is not None:
        cfg.distance_threshold = args.threshold
    downscale = None
    if args.downscale:
        try:
            w, h = (int(v) for v in args.downscale.lower().split("x"))
        except ValueError:
            sys.exit(f"error: --downscale expects WxH, got {args.downscale!r}")
        if w <= 0 or h <= 0:
            sys.exit(f"error: --downscale dimensions must be positive, "
                     f"got {args.downscale!r}")
        downscale = (w, h)
    if args.minsize is None:
        # album parity: the reference organizer builds its engine with
        # minsize=112 (process_photos.py:385); --minsize overrides
        args.minsize = cfg.minsize
    else:
        # AlbumConfig.minsize is authoritative inside AlbumOrganizer:
        # carry an explicit --minsize into the config so the override holds
        cfg.minsize = args.minsize
    analyzer = _build_analyzer(args)
    gallery = _load_gallery(args.gallery, args.device) if args.gallery else None
    organizer = AlbumOrganizer(analyzer, cfg, analyze_batch=args.batch_size,
                               downscale=downscale, gallery=gallery)
    result = organizer.process_album(args.album_dir, use_cache=not args.no_cache)
    print(json.dumps({k: v for k, v in result.items() if k != "clusters"}, indent=2))
    print(f"{len(result['clusters'])} clusters -> {args.album_dir}/clusters/")


def cmd_identify(args):
    from .eval import lfw
    from .models.zoo import build_extractor, weights_origin
    from .pipelines.identification import gallery_probe_eval, gallery_probe_suite

    extractor = build_extractor(args.model, batch_size=args.batch_size,
                                device=args.device)
    g_feats, g_labels, names = lfw.extract_dataset_features(
        args.gallery, extractor, cache_file=args.cache and args.cache + "_gallery.npz")
    # probe labels live in the GALLERY's encoding (facerec_test.py:232-238)
    shared = {n: i for i, n in enumerate(names)}
    p_feats, p_labels, _ = lfw.extract_dataset_features(
        args.probe, extractor, cache_file=args.cache and args.cache + "_probe.npz",
        class_to_label=shared)
    out = {"n_gallery": len(g_labels), "n_probe": len(p_labels),
           "n_classes": len(names), "weights": weights_origin(args.model)}
    if args.classifiers:
        # the full gallery/probe comparison (facerec_test.py:270-288)
        out["classifiers"] = gallery_probe_suite(
            g_feats, g_labels, p_feats, p_labels,
            pca_components=args.pca_components, device=args.device)
    else:
        out["accuracy"] = gallery_probe_eval(g_feats, g_labels, p_feats,
                                             p_labels, k=args.k,
                                             quantized=args.quantized,
                                             device=args.device)
        if args.quantized:
            out["gallery"] = "int8"
    print(json.dumps(out))


def _enroll_face_embeddings(analyzer, people_dir, pairs):
    """(person, rel, largest-face identity) per photo + no-face skip list:
    bounded-prefetch decode, consecutive same-shape photos fused into one
    pow2-padded batch-path call (one upload and one cascade for up to 8
    photos), rotation retry (``process_photos.py:241-247``) individually for
    the rare no-face photos."""
    import numpy as np

    from .serve import _analyze_batch_pow2, _largest_face
    from .utils.image_io import imread_rgb
    from .utils.prefetch import bounded_thread_map

    LANES = 8
    out, retry, buf = [], [], []

    def flush():
        all_faces = _analyze_batch_pow2(
            analyzer, np.stack([im for _, _, im in buf]))
        for (person, rel, img), faces in zip(buf, all_faces):
            if faces:
                out.append((person, rel, _largest_face(faces).identity))
            else:
                retry.append((person, rel, img))
        buf.clear()

    decoded = bounded_thread_map(
        lambda pr: (pr[0], pr[1],
                    imread_rgb(os.path.join(people_dir, pr[1]))),
        pairs, workers=4, depth=2 * LANES)
    for person, rel, img in decoded:
        if buf and buf[0][2].shape != img.shape:
            flush()
        buf.append((person, rel, img))
        if len(buf) == LANES:
            flush()
    if buf:
        flush()

    skipped = []
    for person, rel, img in retry:
        # rotations-only retry: the batch pass already proved upright finds
        # nothing (reference retry order, process_photos.py:241-247)
        for rot in (90, 270):
            rotated = np.ascontiguousarray(
                np.rot90(img, 3 if rot == 90 else 1))
            faces = analyzer.analyze(rotated)
            if faces:
                out.append((person, rel, _largest_face(faces).identity))
                break
        else:
            skipped.append(rel)
    return out, skipped


def cmd_enroll(args):
    """Bulk-enroll a directory-per-person tree into an EnrollmentGallery
    ``.npz`` (the store behind ``serve`` /enroll, /identify and ``album
    --gallery``). The tree follows the reference's gallery-dir convention
    (``facerec_test.py:220-288``): ``people_dir/<Person Name>/*.jpg``.
    mode=face detects and embeds the largest face per photo (unconstrained
    photos); mode=image embeds whole frames (pre-cropped faces)."""
    import numpy as np

    from .pipelines.gallery import EnrollmentGallery
    from .utils.image_io import get_files

    if not os.path.isdir(args.people_dir):
        sys.exit(f"error: people directory not found: {args.people_dir}")
    pairs = get_files(args.people_dir)
    if not pairs:
        sys.exit(f"error: no images under {args.people_dir} (expected "
                 "<person name>/*.jpg subdirectories)")
    gallery = EnrollmentGallery(path=args.gallery_file, device=args.device,
                                quantized=False if args.exact else None)
    skipped: list = []
    if args.mode == "image":
        from .eval import lfw
        from .models.zoo import build_extractor

        extractor = build_extractor(args.model, batch_size=args.batch_size,
                                    device=args.device)
        feats, labels, names = lfw.extract_dataset_features(args.people_dir,
                                                            extractor)
        label_names = [names[int(y)] for y in labels]
    else:
        analyzer = _build_analyzer(args)
        rows, skipped = _enroll_face_embeddings(analyzer, args.people_dir, pairs)
        rows.sort(key=lambda t: t[:2])      # retry results back in order
        label_names = [p for p, _, _ in rows]
        feats = (np.stack([np.asarray(e, np.float32) for _, _, e in rows])
                 if rows else np.zeros((0, 0), np.float32))
    replace_labels = ()
    if args.replace:
        # only persons who produced at least one NEW embedding are replaced,
        # in the same update as the additions; persons whose photos all
        # failed detection keep their old enrollments
        replace_labels = sorted(set(label_names))
        stale = sorted({p for p, _ in pairs} - set(label_names))
        if stale:
            print(f"warning: --replace kept the existing enrollments of "
                  f"{', '.join(stale)} (no face found in any of their new "
                  "photos)", file=sys.stderr)
    n_total = gallery.enroll_many(label_names, feats,
                                  replace_labels=replace_labels)
    print(json.dumps({
        "gallery": args.gallery_file, "n_added": len(label_names),
        "n_people_added": len(set(label_names)), "n_enrolled_total": n_total,
        "skipped_no_face": skipped,
    }))


def cmd_cluster(args):
    """Clustering-quality benchmark on labeled directory-per-person datasets
    (the reference's facial_clustering_test.py flow): per-dataset statistics,
    mean±std across datasets (test_avg_clustering :433-445), and optional
    threshold grid search (:447-499) via --search-threshold."""
    import numpy as np
    import torch

    from .eval import lfw
    from .eval.clustering_metrics import clustering_statistics
    from .models.zoo import build_extractor, weights_origin
    from .ops.distance import pairwise_euclidean
    from .pipelines.clustering import clusters_to_labels, get_facial_clusters

    extractor = build_extractor(args.model, batch_size=args.batch_size,
                                device=args.device)
    datasets = []
    for ds in args.datasets:
        cache = args.cache and f"{args.cache}_{os.path.basename(ds.rstrip('/'))}.npz"
        feats, labels, _ = lfw.extract_dataset_features(ds, extractor,
                                                        cache_file=cache)
        feats = feats / np.maximum(np.linalg.norm(feats, axis=1, keepdims=True),
                                   1e-12)
        f = torch.from_numpy(np.asarray(feats, np.float32)).to(args.device)
        dist = pairwise_euclidean(f, f).cpu().numpy()
        np.fill_diagonal(dist, 0.0)
        datasets.append((ds, dist, labels))

    out = {"weights": weights_origin(args.model), "method": args.method}
    threshold = args.threshold
    if args.search_threshold:
        from .eval.threshold_search import (search_distance_threshold,
                                            search_rankorder_thresholds)

        val = [(d, y) for _, d, y in datasets]
        if args.method in ("rankorder", "rankorder_py"):
            found = search_rankorder_thresholds(val)
        else:
            found = search_distance_threshold(val, method=args.method)
        threshold = found["best_threshold"]
        out["search"] = {"best_threshold": threshold,
                         "best_score": found["best_score"],
                         "trace": found["trace"]}

    per_dataset = {}
    for ds, dist, labels in datasets:
        clusters = get_facial_clusters(dist, threshold, method=args.method)
        y_pred = clusters_to_labels(clusters, len(labels))
        per_dataset[ds] = dict(clustering_statistics(labels, y_pred))
    out["datasets"] = per_dataset
    if len(per_dataset) > 1:
        # mean±std rows (reference test_avg_clustering :439-444)
        keys = next(iter(per_dataset.values())).keys()
        out["mean"] = {k: float(np.mean([s[k] for s in per_dataset.values()]))
                       for k in keys}
        out["std"] = {k: float(np.std([s[k] for s in per_dataset.values()]))
                      for k in keys}
    print(json.dumps(out, indent=2))


def _utkface_predict(args):
    """The selected backend's predict fn on ``--device`` (the reference's
    9-way if/elif chain, ``utkface_test.py:22-314``, as a --backend flag).
    Backends whose external weights are absent build from seeded random
    ones (seed 0), with a warning."""
    import warnings

    import torch

    from .eval import utkface as U

    dev = args.device
    gen = torch.Generator().manual_seed(0)

    def external(init_fn):
        path = args.weights
        if path:
            if not os.path.exists(path):
                sys.exit(f"error: --weights file not found: {path}")
            return None, path
        warnings.warn(f"utkface backend {args.backend!r}: external weights "
                      f"not provided (--weights); using RANDOM init — "
                      "metrics will be meaningless.", RuntimeWarning)
        return init_fn(), None

    if args.backend == "ours":
        from .models.multihead import import_multihead_params
        from .models.zoo import AGEGENDER_PB

        return U.multihead_predict_fn(
            import_multihead_params(args.agegender_pb or AGEGENDER_PB), device=dev)
    if args.backend == "insightface":
        from .models.arcface import init_iresnet_params, iresnet_params_from_npz

        p, path = external(lambda: init_iresnet_params(gen, depth=50, emb_dim=202))
        return U.insightface_predict_fn(
            p if p is not None else iresnet_params_from_npz(path), device=dev)
    if args.backend == "facenet":
        from .models.inception_resnet import (
            inception_resnet_v1_params_from_npz, init_inception_resnet_v1_params)

        p, path = external(lambda: init_inception_resnet_v1_params(gen, with_heads=True))
        return U.facenet_predict_fn(
            p if p is not None else inception_resnet_v1_params_from_npz(path), device=dev)
    if args.backend == "wide_resnet":
        from .models.wide_resnet import init_wide_resnet_params, wide_resnet_params_from_h5

        p, path = external(lambda: init_wide_resnet_params(gen))
        return U.wide_resnet_predict_fn(
            p if p is not None else wide_resnet_params_from_h5(path), device=dev)
    if args.backend == "agendernet":
        from .models.mobilenet_v2 import init_mobilenet_v2_params, mobilenet_v2_params_from_h5

        p, path = external(lambda: init_mobilenet_v2_params(gen))
        return U.agendernet_predict_fn(
            p if p is not None else mobilenet_v2_params_from_h5(path), device=dev)
    if args.backend == "ssrnet":
        from .models.ssrnet import init_ssrnet_params, ssrnet_params_from_h5

        # the reference loads TWO h5s: a morph2 age model and a wiki gender
        # model (utkface_test.py:263-276) — --weights / --gender-weights
        def load(path, which):
            if path:
                if not os.path.exists(path):
                    sys.exit(f"error: --{which} file not found: {path}")
                return ssrnet_params_from_h5(path)
            warnings.warn(f"utkface backend 'ssrnet': {which} h5 not provided;"
                          " using RANDOM init — metrics will be meaningless.",
                          RuntimeWarning)
            return init_ssrnet_params(gen)

        return U.ssrnet_predict_fn(load(args.weights, "weights"),
                                   load(args.gender_weights, "gender-weights"),
                                   device=dev)
    if args.backend == "bknet":
        from .models.bknet import bknet_params_from_npz, init_bknet_params

        p, path = external(lambda: init_bknet_params(gen))
        return U.bknet_predict_fn(
            p if p is not None else bknet_params_from_npz(path), device=dev)
    if args.backend == "converted_pb":
        if not (args.age_pb and args.gender_pb):
            sys.exit("error: --backend converted_pb needs --age-pb and --gender-pb")
        return U.converted_pb_predict_fn(args.age_pb, args.gender_pb, device=dev)
    if args.backend == "converted_logits_pb":
        # rude-carnie tap convention (utkface_test.py:89-109)
        if not (args.age_pb and args.gender_pb):
            sys.exit("error: --backend converted_logits_pb needs --age-pb "
                     "and --gender-pb")
        return U.converted_logits_predict_fn(args.age_pb, args.gender_pb, device=dev)
    sys.exit(f"error: unknown backend {args.backend}")


# the first resize each backend applies itself: --host-resize must equal it
_UTKFACE_INPUT_SIZE = {"ours": 224, "facenet": 160, "agendernet": 96, "ssrnet": 64,
                       "wide_resnet": 64, "bknet": 48, "converted_pb": 256}


def cmd_utkface(args):
    from .eval.utkface import evaluate_age_gender, read_csv_split

    host_resize_to = None
    if args.host_resize:
        # pre-resizing is only a no-op when SIZE equals the first resize the
        # backend itself applies; otherwise the image gets resampled twice
        # with different effective kernels
        if args.backend == "insightface":
            sys.exit("error: --host-resize is invalid for the insightface "
                     "backend (it letterboxes at the original aspect ratio)")
        if args.backend == "converted_logits_pb":
            # this backend resizes straight to each pb's OWN placeholder
            # size (age and gender graphs may even differ)
            sys.exit("error: --host-resize is unsupported for "
                     "converted_logits_pb (input size is read from each "
                     "pb's placeholder)")
        want = _UTKFACE_INPUT_SIZE.get(args.backend)
        if want is not None and args.host_resize != want:
            sys.exit(f"error: --host-resize {args.host_resize} != the "
                     f"{args.backend} backend's input size {want} — the "
                     "image would be resampled twice with different kernels")
        host_resize_to = (args.host_resize, args.host_resize)
    predict = _utkface_predict(args)
    if args.csv_split:
        paths = [os.path.join(args.dataset_dir, f)
                 for f in read_csv_split(args.dataset_dir)]
    else:
        paths = [os.path.join(args.dataset_dir, f)
                 for f in sorted(os.listdir(args.dataset_dir))
                 if f.lower().endswith((".jpg", ".jpeg", ".png"))]
    age_range = (21, 60) if args.coral_subset else None
    # the reference clamps predicted ages to 21-60 unconditionally on its
    # CSV-split path (utkface_test.py:354-358), independent of any gt filter
    clamp = (21, 60) if (args.csv_split or args.coral_subset) else None
    result = dict(evaluate_age_gender(predict, paths, age_range=age_range,
                                      clamp_range=clamp, host_resize_to=host_resize_to))
    result["backend"] = args.backend
    print(json.dumps(result, indent=2))


def cmd_export(args):
    """Export the multi-head model to a frozen pb, a quantized npz, or the
    two-model configuration's age / gender pbs (the reference's conversion
    tooling)."""
    from .core.graphdef_export import export_age_pb, export_gender_pb, export_multihead_pb
    from .models.multihead import import_multihead_params
    from .models.zoo import AGEGENDER_PB
    from .ops.quantize import save_quantized

    pb = args.agegender_pb or AGEGENDER_PB
    if not os.path.exists(pb):
        sys.exit(f"error: weights not found: {pb}")
    params = import_multihead_params(pb)
    if args.format == "pb":
        export_multihead_pb(params, args.out)
    elif args.format == "quantized":
        save_quantized(params, args.out)
    elif args.format == "age_pb":     # two-model configuration halves
        export_age_pb(params, args.out)
    elif args.format == "gender_pb":
        export_gender_pb(params, args.out)
    print(f"exported ({args.format}) -> {args.out}")


def cmd_train(args):
    """Train the face-ID backbone on a directory-per-identity dataset
    (the reference's facerec_keras_train.py recipe)."""
    import numpy as np

    from .config import TrainConfig
    from .train.checkpoints import BestCheckpoint
    from .train.data import DirectoryDataset
    from .train.face_id import FaceIdTrainer

    cfg = TrainConfig(batch_size=args.batch_size, learning_rate=args.lr,
                      epochs=args.epochs, image_size=args.image_size)
    size = (args.image_size, args.image_size)
    train_ds = DirectoryDataset(args.train_dir, size)
    val_ds = DirectoryDataset(args.val_dir, size, class_to_label={
        c: i for i, c in enumerate(train_ds.class_names)}) if args.val_dir else None
    trainer = FaceIdTrainer(n_classes=train_ds.n_classes, cfg=cfg,
                            remat=args.remat, device=args.device)
    ckpt = BestCheckpoint(args.out_dir, name="faceid", mode="max",
                          patience=cfg.early_stopping_patience)
    for epoch in range(cfg.epochs):
        metrics = {}
        for images, labels in train_ds.batches(cfg.batch_size, seed=epoch, epochs=1):
            metrics = trainer.train_batch(images, labels)
        if val_ds is not None:
            val = list(val_ds.batches(cfg.batch_size, shuffle=False, epochs=1,
                                      drop_remainder=False))
            acc = trainer.eval_accuracy(np.concatenate([v[0] for v in val]),
                                        np.concatenate([v[1] for v in val]))
        else:
            acc = metrics.get("acc", 0.0)
        print(f"epoch {epoch}: train {metrics} val_acc={acc:.4f}")
        if not ckpt.update(acc, trainer.params, epoch):
            print("early stopping")
            break
    print(f"best: {ckpt.best} -> {ckpt.best_path}")


def main(argv=None):
    from .models.zoo import MODEL_ZOO

    parser = argparse.ArgumentParser(prog="hse_facerec_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("analyze", help="annotate one image")
    p.add_argument("image")
    p.add_argument("--out", default=None, help="write the annotated image here")
    _add_model_args(p)
    _add_gallery_args(p)
    p.set_defaults(fn=cmd_analyze)

    i = sub.add_parser("images", help="annotate a directory of images")
    i.add_argument("image_dir")
    i.add_argument("out_dir")
    i.add_argument("--batch", type=int, default=8,
                   help="same-shape images per batch-path call (1 = per-image)")
    _add_model_args(i)
    _add_gallery_args(i)
    i.set_defaults(fn=cmd_images)

    v = sub.add_parser("video", help="annotate a video file")
    v.add_argument("video")
    v.add_argument("--out", default=None, help="write annotated mp4")
    v.add_argument("--frame-skip", type=int, default=5)
    v.add_argument("--batch", type=int, default=8,
                   help="frames per batch-path call (1 = per-frame)")
    _add_model_args(v)
    _add_gallery_args(v)
    v.set_defaults(fn=cmd_video)

    wc = sub.add_parser("webcam", help="live webcam demo (ESC quits)")
    wc.add_argument("--camera-index", type=int, default=0)
    _add_model_args(wc)
    _add_gallery_args(wc)
    wc.set_defaults(fn=cmd_webcam)

    al = sub.add_parser("album", help="organize a photo/video album by person")
    al.add_argument("album_dir")
    al.add_argument("--config", default=None, help="reference-format config.txt")
    al.add_argument("--threshold", type=float, default=None)
    al.add_argument("--no-cache", action="store_true")
    al.add_argument("--gallery", default=None, metavar="NPZ",
                    help="enrollment gallery: clusters whose member faces "
                         "majority-match an enrolled person are written "
                         "under that person's name instead of a number")
    al.add_argument("--batch-size", type=int, default=8,
                    help="photos per batch-path call (same-shape photos "
                         "batch together; 1 = sequential)")
    al.add_argument("--downscale", default=None, metavar="WxH",
                    help="downscale larger photos before analysis (e.g. "
                         "640x480): one analysis shape for mixed-resolution "
                         "albums")
    # None = "not explicitly set", so cmd_album applies the reference album
    # default minsize=112 (process_photos.py:385) over the generic 40
    _add_model_args(al, minsize=None)
    al.set_defaults(fn=cmd_album)

    idn = sub.add_parser("identify", help="gallery/probe 1-NN identification")
    idn.add_argument("gallery")
    idn.add_argument("probe")
    idn.add_argument("--model", default="agegender_identity",
                     choices=sorted(MODEL_ZOO))
    idn.add_argument("--k", type=int, default=1)
    idn.add_argument("--classifiers", action="store_true",
                     help="run the full classifier comparison (1/3-NN±PCA, "
                          "rf, svm, linear svm±PCA — facerec_test.py:270-288)")
    idn.add_argument("--pca-components", type=int, default=16)
    idn.add_argument("--batch-size", type=int, default=64)
    idn.add_argument("--quantized", action="store_true",
                     help="enroll the gallery int8 (4x less device memory) "
                          "and rank on the int8 1-NN kernel; k=1 only")
    idn.add_argument("--cache", default=None)
    idn.add_argument("--device", default="cuda")
    idn.set_defaults(fn=cmd_identify)

    en = sub.add_parser("enroll", help="bulk-enroll a people directory into "
                                       "a gallery .npz")
    en.add_argument("people_dir",
                    help="directory with one subdirectory per person")
    en.add_argument("gallery_file", metavar="NPZ",
                    help="enrollment gallery to create or extend")
    en.add_argument("--mode", choices=["face", "image"], default="face",
                    help="face: detect + embed the largest face per photo; "
                         "image: embed whole frames (pre-cropped faces)")
    en.add_argument("--model", default="agegender_identity",
                    choices=sorted(MODEL_ZOO),
                    help="embedder for --mode image (mode=face always uses "
                         "the analyzer's identity features)")
    en.add_argument("--batch-size", type=int, default=64,
                    help="embedder batch for --mode image (mode=face groups "
                         "same-shape photos into 8-lane batch-path calls)")
    en.add_argument("--exact", action="store_true",
                    help="store an f32-ranking gallery instead of int8 (the "
                         "preference persists in the .npz)")
    en.add_argument("--replace", action="store_true",
                    help="atomically swap out the existing enrollments of "
                         "each person that produced new embeddings (persons "
                         "whose photos all fail detection keep their old "
                         "rows, with a warning)")
    _add_model_args(en)
    en.set_defaults(fn=cmd_enroll)

    cl = sub.add_parser("cluster", help="clustering-quality benchmark")
    cl.add_argument("datasets", nargs="+",
                    help="one or more directory-per-person datasets; with "
                         "several, mean±std rows are reported "
                         "(facial_clustering_test.py:433-445)")
    cl.add_argument("--model", default="agegender_identity",
                    choices=sorted(MODEL_ZOO))
    cl.add_argument("--method", default="scipy",
                    choices=["scipy", "rankorder", "rankorder_py", "dbscan"])
    cl.add_argument("--threshold", type=float, default=1.0)
    cl.add_argument("--search-threshold", action="store_true",
                    help="grid-search the distance threshold (2-D distance x "
                         "rank grid for rankorder) with the reference's "
                         "early-stop rules before scoring (:447-499)")
    cl.add_argument("--batch-size", type=int, default=64)
    cl.add_argument("--cache", default=None,
                    help="feature-cache prefix (per-dataset .npz)")
    cl.add_argument("--device", default="cuda")
    cl.set_defaults(fn=cmd_cluster)

    u = sub.add_parser("utkface", help="age/gender benchmark (UTKFace layout)")
    u.add_argument("dataset_dir")
    u.add_argument("--agegender-pb", default=None)
    u.add_argument("--backend", default="ours",
                   choices=["ours", "insightface", "facenet", "wide_resnet",
                            "agendernet", "ssrnet", "bknet", "converted_pb",
                            "converted_logits_pb"],
                   help="the reference's 9-way backend switch "
                        "(utkface_test.py:22-314); converted_pb = DEX-style "
                        "input/prob taps, converted_logits_pb = rude-carnie "
                        "Placeholder/logits taps")
    u.add_argument("--weights", default=None,
                   help="external checkpoint (.npz/.h5) for non-'ours' backends")
    u.add_argument("--gender-weights", default=None,
                   help="second checkpoint for backends with separate "
                        "age/gender models (ssrnet)")
    u.add_argument("--age-pb", default=None)
    u.add_argument("--gender-pb", default=None)
    u.add_argument("--coral-subset", action="store_true",
                   help="restrict to ages 21-60 (CORAL protocol)")
    u.add_argument("--csv-split", action="store_true",
                   help="use utk_test.csv in the dataset dir "
                        "(utkface_test.py:316-330)")
    u.add_argument("--host-resize", type=int, default=None, metavar="SIZE",
                   help="resize every image on the host to SIZE² before "
                        "prediction: one batch shape for mixed-resolution "
                        "datasets. Use the backend's input size (ours: 224). "
                        "Invalid for letterboxing backends (insightface)")
    u.add_argument("--device", default="cuda")
    u.set_defaults(fn=cmd_utkface)

    ex = sub.add_parser("export", help="export model weights (pb / quantized)")
    ex.add_argument("out")
    ex.add_argument("--format", default="pb",
                    choices=["pb", "quantized", "age_pb", "gender_pb"])
    ex.add_argument("--agegender-pb", default=None)
    ex.set_defaults(fn=cmd_export)

    tr = sub.add_parser("train", help="train the face-ID backbone")
    tr.add_argument("train_dir")
    tr.add_argument("--val-dir", default=None)
    tr.add_argument("--out-dir", default="checkpoints")
    tr.add_argument("--batch-size", type=int, default=32)
    tr.add_argument("--lr", type=float, default=1e-3)
    tr.add_argument("--epochs", type=int, default=16)
    tr.add_argument("--image-size", type=int, default=224)
    tr.add_argument("--remat", action="store_true",
                    help="per-block recomputation (activation-memory headroom)")
    tr.add_argument("--device", default="cuda")
    tr.set_defaults(fn=cmd_train)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
