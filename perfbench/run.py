"""One run of one benchmark cell:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  ``BENCHMARK.json`` names the cell's
configuration (``perfbench/configs/<config>.json``) and traffic
(``perfbench/traffic/<traffic>.json``); the traffic's ``loop`` picks the
entry of the program that is driven (``perfbench/loops.py``); the cell's
limits of correctness are ``perfbench/limits/<cell>.json``; each per-layer
metric is read by ``perfbench/metrics/<metric>.py``.

A run: set-up (configuration, weights made on the card from the seed,
the traffic's pool from the seed, the program's detector or training
step, a warm-up through the same entry), then the measured window with
tracing off (``--trace 0``: the cell's end-to-end metrics) or a fixed
traced window under ``torch.profiler`` (``--trace 1``: its per-layer
metrics), then the comparison with the plain reference that decides
``correct``.  The last line of standard output is one JSON object.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = os.getcwd()
HERE = os.path.dirname(os.path.abspath(__file__))
# every cache a run may write stays at a fixed place in the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(ROOT, ".perfbench_cache", _sub)
os.environ["USE_FLAX"] = "0"

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import generate, loops, trace  # noqa: E402
from perfbench.accounting import PEAKS, peak_flop_per_s  # noqa: E402
from perfbench.accounting import bytes as kbytes  # noqa: E402
from perfbench.accounting import flops, frames as frame_facts  # noqa: E402
from perfbench.reference import compare  # noqa: E402
from perfbench.reference import host as ref_host  # noqa: E402
from perfbench.reference import model as R  # noqa: E402
from perfbench.reference import train as ref_train  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mvxnet_makise_tpu")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict          # the configuration file
    traffic: Dict         # the traffic file
    limits: Dict          # name -> limit
    per_layer: List[Dict]  # BENCHMARK.json's per-layer metrics of the cell
    end_to_end: List[Dict]


def load_cell(name: str, overrides: Optional[Dict] = None) -> Cell:
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(ROOT, conf["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    limits_path = os.path.join(HERE, "limits", name + ".json")
    limits = load_json(limits_path)["limits"] if os.path.exists(
        limits_path) else {}
    overrides = overrides or {}
    config = {**config, "config": {**config["config"],
                                   **overrides.get("config", {})}}
    traffic = {**traffic, **overrides.get("traffic", {})}

    def mine(m):
        return name in m.get("workloads", [name])

    return Cell(name, w["chips"], config, traffic,
                {**limits, **overrides.get("limits", {})},
                [m for m in bench["per_layer"] if mine(m)],
                [m for m in bench["end_to_end"] if mine(m)])


def port_config(cell: Cell):
    """The program's Config from the configuration file's YAML fields,
    through the program's own loader."""
    import yaml

    from mvxnet_makise_tpu_torch.config import load_config

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "config.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cell.config["config"], f)
        return load_config(path)


def compute_dtype(cell: Cell) -> torch.dtype:
    """The precision the configuration computes in: bfloat16 for the fused
    model under ``use_bf16``; float32 otherwise, the LiDAR-only model's
    included, whose float32 point features promote its bfloat16-rounded
    weights (``train.state.cast_for_compute``)."""
    if cell.config["config"].get("use_bf16") and cell.config["with_images"]:
        return torch.bfloat16
    return torch.float32


def post_of(mix: Dict) -> Dict:
    """The decode's score threshold and NMS settings of a serving mix, as
    the program's detector takes them and the reference reads them."""
    return {k: mix[k] for k in ("score_threshold", "nms_iou_threshold",
                                "pre_max_size", "post_max_size")}


def ref_params(cfg, params):
    """The weights as the configuration states them: under ``use_bf16``
    the model's parameters are bfloat16 values (the program casts its
    float32 masters for every forward), which the reference rounds for
    itself and then computes with in float32."""
    if not cfg.use_bf16:
        return params
    return {k: v.to(torch.bfloat16).to(v.dtype) for k, v in params.items()}


def ref_config(cfg) -> Dict:
    """What the reference and the accounting read of the configuration."""
    return {"velo_range": tuple(cfg.velo_range),
            "voxel_shape": tuple(cfg.voxel_shape),
            "max_voxels": cfg.max_voxels, "max_points": cfg.max_points,
            "samples_per_voxel": cfg.samples_per_voxel,
            "image_size": tuple(cfg.image_size),
            "image_min_side": cfg.image_min_side,
            "car_size": tuple(cfg.car_size),
            "neg_iou": cfg.class_neg_thresholds[0],
            "pos_iou": cfg.class_pos_thresholds[0],
            "pos_weight": cfg.pos_loss_weight,
            "neg_weight": cfg.neg_loss_weight, "eps": cfg.eps,
            "lr": cfg.learning_rate, "weight_decay": 1e-4}


def read_metric(name: str, ctx: Dict):
    """``perfbench/metrics/<name>.py``'s ``read(ctx)``: a number, or None
    where it finds nothing to read."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

def build_program(cfg, params, with_images: bool, device):
    from mvxnet_makise_tpu_torch.models.mvxnet import build_model

    model = build_model(cfg, seed=None, device=device,
                        with_images=with_images)
    model.load_state_dict(params, strict=True)
    return model


def calib_of(frame: generate.Frame):
    from mvxnet_makise_tpu_torch.geometry.calib import Calib

    cam = frame.camera
    return Calib(velo_to_cam=cam.velo_to_cam, P2=cam.P2, R0=cam.R0)


def profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# serving cells
# ---------------------------------------------------------------------------

def run_serve(cell: Cell, cfg, params, pool, seed: int, seconds: float,
              traced: bool, device) -> Dict:
    from mvxnet_makise_tpu_torch.serve import Detector

    mix = cell.traffic
    with_images = cell.config["with_images"]
    model = build_program(cfg, params, with_images, device)
    det = Detector(cfg, model, with_images=with_images, **post_of(mix))
    frames = [(f.scan, calib_of(f), f.image if with_images else None)
              for f in pool]
    batch = mix["batch"]
    closed = mix["loop"] == "serve_closed"
    # warm-up: the cell's own batch shape through the same entry
    if closed:
        loops.serve_closed(det, frames, batch, count=2 * batch,
                           start=len(frames) - 2 * batch)
    else:
        for i in range(mix["warm_frames"]):
            det.detect_frames([frames[-1 - i]])
    sync(device)
    out: Dict = {"setup_s": time.perf_counter() - _T0}
    host_feed = []
    if traced:
        for i in range(mix["host_feed_batches"]):
            chunk = [frames[(i * batch + j) % len(frames)]
                     for j in range(batch)]
            t = time.perf_counter()
            det.assemble(chunk)
            host_feed.append((time.perf_counter() - t) * 1e3)
    run = (lambda **kw: loops.serve_closed(det, frames, batch, **kw)) \
        if closed else (lambda **kw: loops.serve_open(
            det, frames, mix["rate_hz"], **kw))
    if traced:
        with profiler(device) as prof:
            res = run(count=mix["traced_frames"])
            sync(device)
            res["t1"] = time.perf_counter()
        out["events"] = trace.reduce(prof)
        out["host_feed_ms"] = host_feed
    else:
        res = run(seconds=seconds)
    sync(device)
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    out["window"] = res
    det.close()
    del det, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def serve_check(cell: Cell, cfg, params, pool, res: Dict, seed: int,
                device) -> Dict[str, float]:
    """The reference over a sample of the served frames, drawn from the
    seed, with the frame of the most points in it."""
    served = res["served"]
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0xC0DE])
    n = min(cell.traffic["check_frames"], len(served))
    picks = set(rng.choice(len(served), size=n, replace=False).tolist())
    sizes = [len(pool[idx].scan) for idx, _ in served]
    picks.add(int(np.argmax(sizes)))
    rc = ref_config(cfg)
    with_images = cell.config["with_images"]
    anchors = R.anchors(rc["voxel_shape"], rc["velo_range"], rc["car_size"],
                        device)
    maps, dets, refs = {}, [], []
    for k in sorted(picks):
        idx, d = served[k]
        if idx not in maps:
            f = pool[idx]
            pts, nreal = ref_host.assemble(f.scan, f.camera.rect,
                                           f.camera.proj, rc["velo_range"],
                                           rc["image_size"],
                                           rc["max_points"])
            image = (torch.from_numpy(f.image).to(device)
                     if with_images else None)
            with torch.no_grad():
                maps[idx] = R.forward_frame(
                    torch.from_numpy(pts).to(device), nreal, image,
                    ref_params(cfg, params), rc)
        dets.append((d.boxes, d.scores))
        refs.append(maps[idx])
    return compare.serve_numbers(dets, refs, anchors, post_of(cell.traffic))


# ---------------------------------------------------------------------------
# training cells
# ---------------------------------------------------------------------------

def train_pool(cell: Cell, cfg, pool, seed: int):
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0x7EA1])
    return [generate.train_arrays(f, cfg.velo_range, cfg.image_size,
                                  cfg.max_points, cfg.max_boxes, rng)
            for f in pool]


def batch_of(arrays, i: int, batch: int, device):
    """Batch i of the pool, cycled, uploaded: the step's arguments."""
    rows = [arrays[(i * batch + j) % len(arrays)] for j in range(batch)]
    return tuple(torch.from_numpy(np.stack([r[k] for r in rows])).to(device)
                 for k in range(len(rows[0])))


def check_steps(step, batches, count: int, state, model, params):
    """Set-up's first ``count`` steps, through the window's own call and
    feed, which the reference follows: (each step's loss, each leaf's
    first gradient norm as AdamW has it, each leaf's change after the
    steps)."""
    names = {id(p): n for n, p in model.named_parameters()}
    losses, grad_norms = [], {}

    def record(i, metrics):
        losses.append(float(metrics["total_loss"]))
        if i == 0:
            for p, st in state.optimizer.state.items():
                grad_norms[names[id(p)]] = float(
                    st["exp_avg"].double().norm()) / (1 - 0.9)

    loops.train_loop(step, batches, count=count, after_step=record)
    with torch.no_grad():
        change = {n: float((p.detach() - params[n]).double().norm())
                  for n, p in model.named_parameters()
                  if not R.is_frozen(n)}
    return losses, grad_norms, change


def run_train(cell: Cell, cfg, params, arrays, seed: int, seconds: float,
              traced: bool, device) -> Dict:
    from mvxnet_makise_tpu_torch.ops.assign import create_anchors
    from mvxnet_makise_tpu_torch.train.loop import make_full_train_step
    from mvxnet_makise_tpu_torch.train.state import TrainState

    mix = cell.traffic
    with_images = cell.config["with_images"]
    batch = mix["batch"]
    if device.type == "cuda":
        # the program's training loop runs float32 with TF32 off
        # (train.loop.train); the step alone does not set it
        from mvxnet_makise_tpu_torch.device import use_full_f32

        use_full_f32()
    model = build_program(cfg, params, with_images, device)
    state = TrainState.create(cfg, model)
    anchors = torch.from_numpy(create_anchors(
        cfg.feature_map_shape, cfg.velo_range,
        cfg.anchor_sizes)).to(device)
    step_fn = make_full_train_step(cfg, anchors, with_images)

    def step(*args):
        return step_fn(state, *args)

    def batches(i):
        return batch_of(arrays, i, batch, device)

    n_check = mix["check_steps"]
    program = check_steps(step, batches, n_check, state, model, params)
    sync(device)
    out: Dict = {"setup_s": time.perf_counter() - _T0, "program": program}
    if traced:
        with profiler(device) as prof:
            res = loops.train_loop(step, batches, count=mix["traced_steps"],
                                   start=n_check)
        out["events"] = trace.reduce(prof)
    else:
        res = loops.train_loop(step, batches, seconds=seconds, start=n_check)
    res["batches"] = list(range(n_check, n_check + res["steps"]))
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    out["window"] = res
    del state, model, step_fn
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def ref_batches(arrays, n: int, batch: int, device) -> List[List[Dict]]:
    out = []
    for i in range(n):
        rows = []
        for j in range(batch):
            pts, num, image, gt, mask, _, perm = arrays[
                (i * batch + j) % len(arrays)]
            rows.append({"points": torch.from_numpy(pts).to(device),
                         "num_points": int(num),
                         "perm": torch.from_numpy(perm).to(device),
                         "image": (torch.from_numpy(image).to(device)
                                   if image is not None else None),
                         "gt_boxes": torch.from_numpy(gt).to(device),
                         "gt_mask": torch.from_numpy(mask).to(device)})
        out.append(rows)
    return out


def train_check(cell: Cell, cfg, params, arrays, program,
                device) -> Dict[str, float]:
    losses, grad_norms, change = program
    rc = ref_config(cfg)
    batches = ref_batches(arrays, cell.traffic["check_steps"],
                          cell.traffic["batch"], device)
    ref_losses, ref_grad, ref_change = ref_train.train_steps(
        params, batches, rc)
    return compare.train_numbers(losses, ref_losses, grad_norms,
                                 compare.norms(ref_grad), change,
                                 compare.norms(ref_change))


# ---------------------------------------------------------------------------
# per-layer context
# ---------------------------------------------------------------------------

def frames_in_window(cell: Cell, res: Dict) -> List[int]:
    """Pool indices of the frames the traced window ran, in order."""
    if "served" in res:
        return [idx for idx, _ in res["served"]]
    batch = cell.traffic["batch"]
    n = cell.traffic["pool"]
    return [(i * batch + j) % n for i in res["batches"] for j in range(batch)]


def layer_context(cell: Cell, cfg, pool, arrays, out: Dict,
                  device) -> Dict:
    """What the per-layer readers read: the traced window's events, its
    length, the benchmark's spans, and the work the accounting gives it."""
    res = out["window"]
    ev = out["events"]
    rc = ref_config(cfg)
    with_images = cell.config["with_images"]
    idxs = frames_in_window(cell, res)
    facts = {}
    for idx in set(idxs):
        if arrays is not None:
            pts, num, _, _, _, _, perm = arrays[idx]
            p = torch.from_numpy(pts).to(device)[
                torch.from_numpy(perm).to(device)]
            real = torch.from_numpy(perm).to(device) < int(num)
            p = torch.cat([p[real], p[~real]])
            facts[idx] = frame_facts.stats(p, int(num), rc, with_images)
        else:
            f = pool[idx]
            pts, n = ref_host.assemble(f.scan, f.camera.rect, f.camera.proj,
                                       rc["velo_range"], rc["image_size"],
                                       rc["max_points"])
            facts[idx] = frame_facts.stats(torch.from_numpy(pts).to(device),
                                           n, rc, with_images)
    batch = cell.traffic["batch"]
    batches = [[facts[i] for i in idxs[k:k + batch]]
               for k in range(0, len(idxs), batch)]
    dtype = compute_dtype(cell)
    elem = dtype.itemsize
    training = arrays is not None
    count = flops.train if training else flops.forward
    lo = min((s for _, s, _ in ev["device"]), default=0.0)
    spans = ev["spans"]
    unit = spans.get(loops.STEP) or spans.get(loops.BATCH) or \
        spans.get(loops.FRAME) or []
    if unit:
        lo = min(s for s, _ in unit)
        hi = max(e for _, e in unit)
    else:
        hi = max((e for _, _, e in ev["device"]), default=lo)
    merged = trace.union([(s, e) for _, s, e in ev["device"]])
    return {
        "cell": cell.name, "events": ev, "lo": lo, "hi": hi,
        "window_s": hi - lo, "busy_s": trace.covered(merged, lo, hi),
        "merged": merged, "frames": len(idxs),
        "steps": res.get("steps", 0),
        "flops": sum(count(facts[i], rc, with_images) for i in idxs),
        "peaks": PEAKS,
        "peak_flop_per_s": peak_flop_per_s(dtype),
        "k1_bound_s": sum(kbytes.k1(b, rc, elem) for b in batches),
        "k1_bwd_bound_s": sum(kbytes.k1_backward(b, rc, elem)
                              for b in batches),
        "k2_bound_s": (sum(kbytes.k2(b, rc, elem) for b in batches)
                       if with_images else 0.0),
        "host_feed_ms": out.get("host_feed_ms", []),
    }


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", overrides: Optional[Dict] = None
             ) -> Dict:
    """One run of the cell; returns the result object (the last line)."""
    return run_once(name, seed, seconds, traced, device, overrides)[0]


def run_once(name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", overrides: Optional[Dict] = None):
    """One run of the cell: (the result object, every number the
    comparison read, held or not)."""
    from perfbench import dp

    cell = load_cell(name, overrides)
    if cell.traffic["loop"] == "train_dp":
        out, numbers = dp.run_dp(name, seed, seconds, traced, device,
                                 overrides, cell.chips, _T0)
        return result_of(cell, out, numbers, traced, device)
    with dp.fault(overrides):
        return run_one_card(cell, seed, seconds, traced, device)


def run_one_card(cell: Cell, seed: int, seconds: float, traced: bool,
                 device: str):
    """One run of a one-card cell: (the result object, the numbers)."""
    dev = torch.device(device)
    cfg = port_config(cell)
    rc = ref_config(cfg)
    with_images = cell.config["with_images"]
    spec = R.param_spec(with_images)
    params = R.make_params(spec, seed, dev)
    mix = cell.traffic
    pool = generate.make_pool(seed, mix, cfg.velo_range, cfg.image_size,
                              cfg.car_size)
    training = mix["loop"] == "train"
    arrays = train_pool(cell, cfg, pool, seed) if training else None
    if training:
        out = run_train(cell, cfg, params, arrays, seed, seconds, traced,
                        dev)
    else:
        out = run_serve(cell, cfg, params, pool, seed, seconds, traced, dev)
    res = out["window"]
    found = sorted(m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN)
    if found:
        log("modules of JAX or of the JAX package are loaded:", found)
        raise SystemExit(4)
    metrics: Dict = {}
    device_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                  "count": cell.chips,
                  "memory_peak_bytes": int(out["memory_peak_bytes"])}
    breakdown = None
    if traced:
        ctx = layer_context(cell, cfg, pool, arrays, out, dev)
        device_rec["busy_s"] = ctx["busy_s"]
        device_rec["window_s"] = ctx["window_s"]
        for m in cell.per_layer:
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = trace.breakdown(out["events"], ctx["lo"], ctx["hi"])
    else:
        window = res["t1"] - res["t0"]
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                v = out["setup_s"]
            elif m["name"] == "serve_frames_per_s":
                v = len(res["served"]) / window
            elif m["name"] == "train_frames_per_s":
                v = res["steps"] * mix["batch"] / window
            elif m["name"] == "frame_latency_p95_ms":
                v = loops.percentile(res["latency"], 95) * 1e3
            else:
                continue
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if "late" in res and res["late"]:
            log(f"generator lateness: median "
                f"{np.median(res['late']) * 1e3:.4f} ms, max "
                f"{np.max(res['late']) * 1e3:.4f} ms over "
                f"{len(res['late'])} frames sent to an idle server")
    # correctness: the program's state is freed; the reference in float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    if training:
        numbers = train_check(cell, cfg, params, arrays, out["program"], dev)
    else:
        numbers = serve_check(cell, cfg, params, pool, res, seed, dev)
    log(f"reference check: {time.perf_counter() - t:.3f} s, numbers "
        f"{json.dumps(numbers)}")
    ok, rows = compare.verdict(numbers, cell.limits)
    result = {"correct": ok, "attempted": int(res["attempted"]),
              "failed": int(res["failed"]), "metrics": metrics,
              "device": device_rec}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {r["name"]: {"value": r["value"],
                                    "limit": r["limit"]} for r in rows}
    for r in rows:
        log(f"check {r['name']}: {r['value']!r} (limit {r['limit']!r})")
    return result, numbers


def result_of(cell: Cell, out: Dict, numbers: Dict, traced: bool,
              device: str):
    """The result object of a data-parallel run (``perfbench/dp.py``),
    assembled on rank 0: (result, numbers)."""
    found = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if found:
        log("modules of JAX or of the JAX package are loaded:", found)
        raise SystemExit(4)
    res = out["window"]
    world = cell.chips
    device_rec = {"platform": "gpu" if device == "cuda" else device,
                  "kind": (torch.cuda.get_device_name(0)
                           if device == "cuda" else "cpu"),
                  "count": world,
                  "memory_peak_bytes": int(out["memory_peak_bytes"])}
    metrics: Dict = {}
    if traced:
        ctx = out["dp_context"]
        device_rec["busy_s"] = ctx["busy_s"]
        device_rec["window_s"] = ctx["window_s"]
        for m in cell.per_layer:
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        frames = res["steps"] * cell.traffic["batch"] * world
        values = {"setup_s": out["setup_s"],
                  "train4_frames_per_s": frames / (res["t1"] - res["t0"])}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}
    log(f"reference check numbers {json.dumps(numbers)}")
    ok, rows = compare.verdict(numbers, cell.limits)
    result = {"correct": ok, "attempted": int(res["attempted"]),
              "failed": int(res["failed"]), "metrics": metrics,
              "device": device_rec}
    if traced:
        result["breakdown"] = out["dp_context"]["breakdown"]
    result["checks"] = {r["name"]: {"value": r["value"],
                                    "limit": r["limit"]} for r in rows}
    for r in rows:
        log(f"check {r['name']}: {r['value']!r} (limit {r['limit']!r})")
    return result, numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"the cell needs {cell.chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    if args.seed < 0:
        log("--seed must be a whole number of 0 or more")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
