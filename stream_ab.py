#!/usr/bin/env python3
"""Time ``serve.Detector.detect_stream`` of this checkout against another
commit's, in turns, on one CUDA card: ms per frame and each frame's
latency.

    python3 stream_ab.py OTHER_SERVE_PY

``OTHER_SERVE_PY`` is another commit's ``mvxnet_makise_tpu_torch/serve.py``
(for instance the parent's, written out with ``git show`` into a directory
that ``.gitignore`` lists).  It is loaded as a module of its own and its
``Detector.detect_stream`` is called on this checkout's Detector, so the
streaming loop is the only difference: the other loop may call only
methods this Detector has (a parent's calls ``assemble`` and
``detect_batch``).

Cases: ``configs/full_fusion.yaml`` at its batch 4 and at batch 1 (a
perception loop's one frame at a time), and ``configs/serving_economy.yaml``
at its batch 8, as written, random weights from seed 0, synthetic frames
from seed 4.  Each case first holds both loops' detections against
``detect_frames`` (exactly), then streams in the order other, this, this,
other for ``ROUNDS`` rounds: unpaced (the input hands a frame over as soon
as the loop asks; ms per frame), then paced (the input hands frame k over
at ``k * PERIOD_MS``, a 10 Hz LiDAR).  A frame's latency runs from the
moment the input hands it over to the moment its ``FrameDetections`` (on
the host) is yielded.  Prints one JSON line per case with every run's ms
per frame and median and largest latency, and their medians per loop and
pacing, then the card's name and power limit.  Exits nonzero
without a card or when a loop's detections differ.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CASES = (("full_fusion", None), ("full_fusion", 1), ("serving_economy", None))
BATCHES_PER_STREAM = 6
ROUNDS = 4
PERIOD_MS = 100.0


def load_other(path: str):
    spec = importlib.util.spec_from_file_location("other_serve", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Detector.detect_stream


def stream(loop, det, frames, batch_size, period_ms=None) -> dict:
    """One stream of ``frames`` through ``loop``, frame k handed over no
    sooner than ``k * period_ms`` when it is given: the results, ms per
    frame, and the frames' median and largest latency in ms."""
    import numpy as np

    t_in = []

    def pulled():
        for k, f in enumerate(frames):
            if period_ms is not None:
                time.sleep(max(0.0, t0 + k * period_ms / 1e3
                               - time.perf_counter()))
            t_in.append(time.perf_counter())
            yield f

    out, t_out = [], []
    t0 = time.perf_counter()
    for r in loop(det, pulled(), batch_size):
        t_out.append(time.perf_counter())
        out.append(r)
    ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    lat = [(b - a) * 1e3 for a, b in zip(t_in, t_out)]
    return {"results": out, "ms_per_frame": ms,
            "latency_median_ms": float(np.median(lat)),
            "latency_max_ms": max(lat)}


def same(a, b) -> bool:
    import numpy as np

    return len(a) == len(b) and all(
        np.array_equal(x.boxes, y.boxes) and np.array_equal(x.scores, y.scores)
        and np.array_equal(x.classes, y.classes) for x, y in zip(a, b))


def main(other_serve: str) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("stream_ab.py needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from mvxnet_makise_tpu_torch.config import load_config
    from mvxnet_makise_tpu_torch.serve import Detector

    loops = {"other": load_other(other_serve),
             "this": Detector.detect_stream}
    ok = True
    for name, batch in CASES:
        cfg = load_config(os.path.join(ROOT, "configs", name + ".yaml"))
        bs = batch or cfg.batch_size
        det = Detector.create(cfg, checkpoint_epoch=0, seed=0, device="cuda")
        try:
            det.warm((bs,))
            frames = cs.make_frames(cfg, bs * BATCHES_PER_STREAM, seed=4)
            want = []
            for i in range(0, len(frames), bs):
                want += det.detect_frames(frames[i:i + bs])
            equal = {n: same(stream(fn, det, frames, bs)["results"], want)
                     for n, fn in loops.items()}
            ok &= all(equal.values())
            runs = {p: {n: [] for n in loops}
                    for p in ("unpaced", "paced")}
            for pace, period in (("unpaced", None), ("paced", PERIOD_MS)):
                for r in range(ROUNDS):
                    for n in ("other", "this")[::1 - r % 2 * 2]:
                        s = stream(loops[n], det, frames, bs, period)
                        s.pop("results")
                        runs[pace][n].append(s)
        finally:
            det.close()
        torch.cuda.synchronize()
        print(json.dumps({
            "case": name, "batch_size": bs, "frames": len(frames),
            "equal_to_detect_frames": equal, "runs": runs,
            "median": {p: {n: {k: float(np.median([s[k] for s in v]))
                               for k in v[0]} for n, v in by.items()}
                       for p, by in runs.items()}}),
            flush=True)
        del det
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
