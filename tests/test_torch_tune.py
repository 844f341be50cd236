"""The `--tune` grids of the port's five training CLIs on the CPU at MiT-B0
64x64, against the JAX CLIs:

- `core/config.py::product_grid` gives the JAX package's point order for
  each grid's defaults and two seeds;
- `cli/common.py::sweep_grid` prints what the JAX function prints for a
  grid, an empty grid and a grid without a finite objective;
- each CLI (the teacher-student CLI in both loops) runs its points in the
  JAX CLI's order, writes one CSV per point named by the JAX CLI's tag,
  writes no checkpoint, ignores --resume (with the JAX CLI's words where it
  has them), and a point's CSV equals the port's own non-tune run of that
  point's hyperparameters at epochs // 5 to 1e-6.
"""

import contextlib
import copy
import csv
import io
import math
import os
import tempfile

import pytest

from semisupervisedobjectdetection_tpu.cli import common as jcommon
from semisupervisedobjectdetection_tpu.core import config as jconfig
from semisupervisedobjectdetection_torch.api import SegFormerModel
from semisupervisedobjectdetection_torch.cli import (
    autoencoder,
    common,
    fewshot,
    supervised,
    teacher_student,
    transfer,
)
from semisupervisedobjectdetection_torch.core.config import product_grid
from semisupervisedobjectdetection_torch.utils.logging import MetricLogger
from test_torch_segformer import one_torch_thread  # noqa: F401 (autouse)

TILES = ["--synthetic", "--device", "cpu", "--variant", "b0", "--img-size",
         "64", "--seed", "0", "--epochs", "5"]
ARGS = TILES + ["--synthetic-n", "8", "--batch-size", "4"]
FEWSHOT_ARGS = TILES + ["--iterations", "1"]
# columns that are times, not results
TIMES = {"wall_s", "fps", "sec_per_batch"}

# the five grids' default axes (the JAX CLIs' flags and constants)
DEFAULT_GRIDS = {
    "transfer": ([1e-4, 5e-5, 1e-5], [(0, 1), (0, 1, 2)], [1, 10, 100]),
    "autoencoder": ([1e-4, 5e-5, 1e-5], [5e-5], [0.97]),
    "teacher_student": ([5e-7], [3e-5], [0.8, 0.7], [0.8, 0.85, 0.87]),
    "fewshot": ([8e-5, 5e-5, 2e-5, 5e-6], [5e-5], [0.97]),
    "supervised": ([1e-4, 3e-5, 1e-5, 3e-6],),
}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(DEFAULT_GRIDS))
def test_product_grid_matches_jax(name, seed):
    axes = DEFAULT_GRIDS[name]
    got = product_grid(*axes, shuffle=True, seed=seed)
    assert got == jconfig.product_grid(*axes, shuffle=True, seed=seed)
    assert sorted(got) == sorted(product_grid(*axes))
    assert len(got) == math.prod(len(a) for a in axes)


class _Args:
    metrics_csv = None


@pytest.mark.parametrize("objectives", [
    [0.5, float("nan"), 0.25], [float("nan"), float("nan")], []],
    ids=["mixed", "all_nan", "empty"])
def test_sweep_grid_prints_what_jax_prints(objectives):
    grid = [(float(i), "x") for i in range(len(objectives))]

    def run(sweep):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            try:
                got = sweep(_Args(), grid, lambda pt, log: objectives[
                    int(pt[0])], tag_of=lambda p: f"p{p[0]}",
                    show_of=lambda p: f"point={p[0]}",
                    empty_hint="check --tune-lrs")
            except SystemExit as e:
                got = ("exit", str(e))
        return got, out.getvalue()

    port, jax = run(common.sweep_grid), run(jcommon.sweep_grid)
    assert port[1] == jax[1]
    if not objectives:
        assert port[0] == jax[0] == (
            "exit", "--tune grid is empty (check --tune-lrs)")
        return
    (best, best_pt), (jbest, jbest_pt) = port[0], jax[0]
    assert best_pt == jbest_pt and best == jbest
    last = port[1].splitlines()[-1]
    if all(math.isnan(x) for x in objectives):
        assert best_pt is None and last == (
            "tune: no grid point produced a finite best eval "
            f"({len(grid)} points tried)")
    else:
        assert last == "best: point=2.0 loss=0.2500"


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _same_rows(got, want):
    """The two runs' CSV rows agree in every result column to 1e-6."""
    assert len(got) == len(want) >= 1
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for key in set(a) - TIMES:
            assert math.isclose(float(a[key]), float(b[key]), rel_tol=0,
                                abs_tol=1e-6), (key, a[key], b[key])


def _lr_grid(seed):
    return [(1e-4,), (2e-5,)]


def _transfer_grid(seed):
    return jconfig.product_grid([1e-4], [(0, 1), (0, 1, 2)], [1, 2],
                                shuffle=True, seed=seed)


def _wd_grid(lrs, cap):
    def grid(seed):
        return jconfig.product_grid(lrs, [5e-5], [0.97], shuffle=True,
                                    seed=seed)[:cap]
    return grid


def _ts_grid(seed):
    return jconfig.product_grid([5e-7], [3e-5], [0.8, 0.7],
                                [0.8, 0.85, 0.87], shuffle=True, seed=seed)


def _lr_wd_tag(p):
    return f"lr{p[0]}_wd{p[1]}_g{p[2]}"


def _lr_wd_show(p):
    return f"lr={p[0]} weight_decay={p[1]} scheduler={p[2]}"


def _ts_flags(p):
    return ["--teacher-lr", str(p[0]), "--student-lr", str(p[1]),
            "--supervise-weight", str(p[2]), "--threshold", str(p[3])]


# per CLI: its main, the tune flags, the expected grid (the JAX CLI's
# order), the JAX CLI's tag and shown name of a point, the objective's
# name, the JAX CLI's --resume message (None where it prints none), and
# the flags of a non-tune run of a point (None: the run goes through the
# loop's function on the tune split, as the CLI has no flag for it)
CLIS = {
    "supervised": (supervised.main, ARGS + ["--tune-lr", "1e-4,2e-5"],
                   _lr_grid, lambda p: f"lr{p[0]}", lambda p: f"lr={p[0]}",
                   "best eval loss", None, None),
    "transfer": (transfer.main, ARGS + ["--tune", "--tune-lrs", "1e-4",
                                        "--tune-tokens", "1,2"],
                 _transfer_grid,
                 lambda p: f"lr{p[0]}_fz{'-'.join(map(str, p[1]))}_tok{p[2]}",
                 lambda p: f"lr={p[0]} frozen={p[1]} tokens={p[2]}",
                 "best eval",
                 "--resume is ignored under --tune (each grid point would "
                 "otherwise restore the previous point's _last checkpoint)",
                 lambda p: ARGS + ["--lr", str(p[0]), "--frozen",
                                   ",".join(map(str, p[1])),
                                   "--prompt-tokens",
                                   ",".join([str(p[2])] * 4)]),
    "autoencoder": (autoencoder.main, ARGS + ["--tune", "--tune-lrs",
                                              "1e-4,1e-5", "--tune-max",
                                              "2"],
                    _wd_grid([1e-4, 1e-5], 2), _lr_wd_tag, _lr_wd_show,
                    "best train+eval",
                    "--resume is ignored under --tune (grid points must not "
                    "share one _last checkpoint)", None),
    "teacher_student": (teacher_student.main, ARGS + ["--tune"], _ts_grid,
                        lambda p: f"tlr{p[0]}_slr{p[1]}_w{p[2]}_thr{p[3]}",
                        lambda p: (f"t_lr={p[0]} s_lr={p[1]} w={p[2]} "
                                   f"thr={p[3]}"),
                        "best eval", None, lambda p: ARGS + _ts_flags(p)),
    "teacher_student_ema": (
        teacher_student.main, ARGS + ["--tune", "--ema-mode"], _ts_grid,
        lambda p: f"tlr{p[0]}_slr{p[1]}_w{p[2]}_thr{p[3]}",
        lambda p: f"t_lr={p[0]} s_lr={p[1]} w={p[2]} thr={p[3]}",
        "best eval", None,
        lambda p: ARGS + ["--ema-mode"] + _ts_flags(p)),
    "fewshot": (fewshot.main, FEWSHOT_ARGS + ["--tune", "--tune-max", "2"],
                _wd_grid([8e-5, 5e-5, 2e-5, 5e-6], 2), _lr_wd_tag,
                _lr_wd_show, "best eval",
                "--resume is ignored under --tune (grid points must not "
                "share one _last checkpoint)",
                lambda p: FEWSHOT_ARGS + ["--lr", str(p[0]),
                                          "--weight-decay", str(p[1]),
                                          "--scheduler", str(p[2])]),
}


def _loop_run(name, seen, point, csv_path):
    """The point's run through the CLI's own training loop (not the tune
    path), on the tune path's 80/20 split: supervised and autoencoder."""
    args = copy.copy(seen["args"])
    args.checkpoint_dir = None
    dcfg, cfg, tc = seen["dcfg"], seen["cfg"], seen["tc"]
    tc = tc.replace(epochs=max(tc.epochs // 5, 1))
    logger = MetricLogger(csv_path)
    try:
        if name == "supervised":
            sub = common.split_loaders(dcfg, seen["loaders"]["train"].dataset,
                                       args.seed)
            model = SegFormerModel(lr=point[0], train_config=tc, config=cfg,
                                   seed=args.seed, device="cpu")
            supervised.train_loop(model, sub, dcfg, tc, args, logger)
        else:
            dcfg = common.ensure_data(args, dcfg)
            train = common.make_loaders(dcfg, args.seed, flags=("train",))
            sub = common.split_loaders(dcfg, train["train"].dataset,
                                       args.seed)
            tc = tc.replace(lr=point[0], weight_decay=point[1],
                            lr_decay=point[2])
            model = SegFormerModel(num_labels=3, train_config=tc,
                                   config=cfg, seed=args.seed, device="cpu")
            autoencoder.train_loop(model, sub, dcfg, tc, args, logger)
    finally:
        logger.close()


@pytest.mark.parametrize("name", sorted(CLIS))
def test_tune_grid_matches_the_jax_cli(name, tmp_path, monkeypatch):
    main, flags, grid_of, tag_of, show_of, objective, resume_msg, \
        single = CLIS[name]
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the tiles
    seen = {}
    if single is None:
        # keep what the tune path was given, for the loop run below
        mod = supervised if name == "supervised" else autoencoder
        fn = "tune_lr" if name == "supervised" else "tune"
        real = getattr(mod, fn)

        def spy(args, cfg, dcfg, tc, *rest):
            seen.update(args=args, cfg=cfg, dcfg=dcfg, tc=tc,
                        loaders=rest[0] if name == "supervised" else None)
            return real(args, cfg, dcfg, tc, *rest)

        monkeypatch.setattr(mod, fn, spy)
    ck, csvs = tmp_path / "ck", tmp_path / "m"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        best, best_pt = main(flags + [
            "--resume", "--checkpoint-dir", str(ck),
            "--metrics-csv", str(csvs / "m.csv")])
    printed = out.getvalue().splitlines()
    grid = grid_of(0)
    # the points in the JAX CLI's order, each with its objective
    points = [ln for ln in printed if f": {objective} " in ln]
    assert [ln.rsplit(f": {objective} ", 1)[0] for ln in points] == \
        [show_of(p) for p in grid]
    got = [float(ln.rsplit(" ", 1)[1]) for ln in points]
    assert printed[-1] == f"best: {show_of(best_pt)} loss={best:.4f}"
    assert f"{best:.4f}" == f"{min(got):.4f}" and best_pt in grid
    # one CSV per point, by the JAX CLI's tag; no checkpoint; no resume
    assert sorted(os.listdir(csvs)) == sorted(f"m.{tag_of(p)}.csv"
                                              for p in grid)
    assert not ck.exists()
    if resume_msg is not None:
        assert resume_msg in printed
    assert not any(ln.startswith("resumed") for ln in printed)
    # the first point against the port's own run of its hyperparameters
    pt = grid[0]
    want = tmp_path / "single.csv"
    with contextlib.redirect_stdout(io.StringIO()):
        if single is None:
            _loop_run(name, seen, pt, str(want))
        else:
            main(single(pt) + ["--epochs", "1", "--checkpoint-dir", "",
                               "--metrics-csv", str(want)])
    _same_rows(_rows(csvs / f"m.{tag_of(pt)}.csv"), _rows(want))
