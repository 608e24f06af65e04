"""PyTorch port: the synthetic generalization protocol
(``tools/gen_experiment.py``, ``tools/probe.RPN_VARIANTS``) against the
JAX package's tool.

The trunk table and every ``make_config`` (each ``--rpn``, each
``--classes``) equal JAX's field by field; the training pool (seed 1,
through ``train.loop.preprocess_train_frame``) and the val frames (seed
10 000) are bit-equal between the packages; and a 6-step CPU run writes
one record line per eval with JAX's keys, ``best.per_class_max`` in every
line (JAX's tool drops it when an eval sets a new best: the regression
this guards).
"""

import dataclasses
import json

import numpy as np
import pytest

from mvxnet_makise_tpu.tools import gen_experiment as jax_gen
from mvxnet_makise_tpu.tools.probe import RPN_VARIANTS as JAX_VARIANTS
from mvxnet_makise_tpu.train.loop import (
    preprocess_train_frame as jax_preprocess,
)
from mvxnet_makise_tpu_torch.tools import gen_experiment
from mvxnet_makise_tpu_torch.tools.probe import (
    RPN_VARIANTS,
    rpn_fields,
    rpn_name,
)


def test_rpn_variants_equal_jax():
    assert RPN_VARIANTS == JAX_VARIANTS
    for name in RPN_VARIANTS:
        cfg = gen_experiment.make_config("reference", 1e-3, 4, rpn=name)
        assert rpn_name(cfg.rpn_trunk) == name
    with pytest.raises(ValueError, match="unknown RPN trunk"):
        rpn_fields("no-such-trunk")


@pytest.mark.parametrize("rpn", [None, *JAX_VARIANTS])
@pytest.mark.parametrize("classes", [1, 2, 3])
def test_make_config_matches_jax(rpn, classes):
    args = ("focal", 3e-4, 4, 32, classes, 45.0 if rpn else None, rpn)
    want = jax_gen.make_config(*args)
    got = gen_experiment.make_config(*args)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("classes", [1, 3])
def test_pool_and_val_frames_are_jax_bit_for_bit(classes):
    cfg = gen_experiment.make_config("reference", 1e-3, 4, 32, classes)
    jcfg = jax_gen.make_config("reference", 1e-3, 4, 32, classes)
    pool = gen_experiment.make_pool(cfg, 4, np.random.default_rng(1))
    jrng = np.random.default_rng(1)
    want = [jax_preprocess(jax_gen.make_frame(i, jrng, jcfg), jcfg, None,
                           jrng) for i in range(4)]
    for got, (w, wcls) in zip(pool, want):
        np.testing.assert_array_equal(got.points, w.points)
        assert got.num_points == w.num_points
        np.testing.assert_array_equal(got.image, w.image)
        np.testing.assert_array_equal(got.gt_boxes, w.gt_boxes)
        np.testing.assert_array_equal(got.gt_mask, w.gt_mask)
        np.testing.assert_array_equal(got.gt_classes, wcls)
    assert sum(int(p.gt_mask.sum()) for p in pool) > 0

    val = gen_experiment.make_val(cfg, 2)
    vrng = np.random.default_rng(10_000)
    for i, got in enumerate(val):
        w = jax_gen.make_frame(10_000 + i, vrng, jcfg)
        assert got.frame_id == w.frame_id
        np.testing.assert_array_equal(got.points, w.points)
        np.testing.assert_array_equal(got.image, w.image)
        assert got.boxes.keys() == w.boxes.keys()
        for c in w.boxes:
            np.testing.assert_array_equal(got.boxes[c], w.boxes[c])
            np.testing.assert_array_equal(got.difficulty[c],
                                          w.difficulty[c])


def _jax_record_keys(tmp_path):
    """The keys of a line JAX's ``_append_record`` writes."""
    path = tmp_path / "jax.jsonl"
    last = {0.5: {"ap": 0.0, "recall": 0.0}, 0.7: {"ap": 0.0, "recall": 0.0}}
    jax_gen._append_record(str(path), True, 0, 4, 2, 32, 1, "reference",
                           False, None, None, 0.0, last, {})
    return set(json.loads(path.read_text()))


def test_cpu_run_records_every_eval_with_per_class_max(tmp_path, capsys):
    record = tmp_path / "runs.jsonl"
    last = gen_experiment.run(6, 4, 3, "reference", 1e-3, 2, n_val=2,
                              log_every=3, world=32, record=str(record),
                              device="cpu")
    out = capsys.readouterr().out
    assert "step 6 VAL Car AP@0.5" in out
    lines = [json.loads(ln) for ln in record.read_text().splitlines()]
    assert [ln["steps"] for ln in lines] == [3, 6]
    assert [ln["final"] for ln in lines] == [False, True]
    keys = _jax_record_keys(tmp_path)
    for ln in lines:
        assert keys <= set(ln)
        assert ln["backend"] == "cpu" and ln["device"] == "cpu"
        assert ln["elapsed_s"] > 0 and ln["steps_per_s"] > 0
        assert set(ln["best"]["per_class_max"]) == {"Car"}
        assert 0.0 <= ln["ap50"] <= 1.0
    # the final eval rebuilt best (AP 0 >= 0) and kept the maxima
    assert lines[1]["best"]["step"] == 6
    assert lines[1]["best"]["per_class_max"]["Car"]["step"] == 3
    assert last["best"] == lines[1]["best"]
    assert len(last["history"]) == 6 and last["steps_per_s"] > 0
    assert all(np.isfinite(h["total_loss"]) for h in last["history"])


def test_cli_refuses_the_jax_protocol_file(tmp_path):
    with pytest.raises(SystemExit):
        gen_experiment.main(["--record", str(tmp_path / "GEN_PROTOCOL.jsonl"),
                             "--device", "cpu"])


def _rpn_flops(C, H, W, trunk, A=2):
    """Multiply-add FLOPs of the RPN's convolutions, by hand."""
    (c1, c2, c3), (e1, e2, e3), d = trunk
    h1, h2, h3 = (H // 2) * (W // 2), (H // 4) * (W // 4), (H // 8) * (W // 8)
    macs = (9 * C * c1 * h1 + e1 * 9 * c1 * c1 * h1
            + 9 * c1 * c2 * h2 + e2 * 9 * c2 * c2 * h2
            + 9 * c2 * c3 * h3 + e3 * 9 * c3 * c3 * h3
            + 9 * c1 * d * h1 + 4 * c2 * d * h2 + 16 * c3 * d * h3
            + 3 * d * A * h1 + 3 * d * A * 7 * h1)
    return 2 * macs


@pytest.mark.parametrize("name", ["reference", "half-extra333"])
def test_probe_counts_the_rpn_convolutions(name):
    import torch

    from mvxnet_makise_tpu_torch.models.voxelnet import RPN
    from mvxnet_makise_tpu_torch.tools.probe import conv_flops

    trunk = RPN_VARIANTS[name]
    x = torch.zeros(1, 128, 32, 40)
    assert conv_flops(RPN(128, trunk=trunk), x) == _rpn_flops(128, 32, 40,
                                                              trunk)


def test_probe_occupancy_on_the_cpu_and_card_only_timings(capsys):
    from mvxnet_makise_tpu_torch.tools import probe

    assert probe.main(["occupancy", "--frames", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "A0 active cols" in out and "RPN blk3 (44x50)" in out
    for cmd in ("rpn", "tablecost"):
        with pytest.raises(SystemExit):
            probe.main([cmd, "--device", "cpu"])
