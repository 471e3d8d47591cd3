"""A training cell: fine-stage steps of the port in a closed loop.

Set-up builds one training state at the configuration's capacity (the true
scene perturbed, Adam's count at `assumed.adam_count`, fresh moments),
renders the targets of the bank's views with the reference, grows the
binner's caps from the configuration's (`assumed.caps`) by the port's rule until no bank view drops a pair at three
quarters of the tile cap and the pairs fill at most three quarters of the
budget (`program.grow_caps`), and
drives the state through its first `check_steps` steps by the call the
window makes (`graphs.StepPrograms.run` on `loop.step_of_key`'s fine key,
the call `run_stage` makes each iteration; eager on the CPU), the first of
them capturing the step. It keeps the losses of those steps, the first
gradient (Adam's first moment after one step, over 1 - beta1) and the
parameters after them. Then `warmup_steps` more, and the window: steps in
epoch order from the bank until `seconds` have passed, closed by one
synchronize. A step fails if its loss is not finite or it drops a pair.

After the window (and the memory peak's reading) the program is freed and
the reference follows the same first steps from the same state in blocks
of tiles (`reference/train.py`); the first step's loss, the worst leaf's
first-gradient norm and the median leaf's change are compared
(`_compare`).
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import work
from portbench.core import cameras, program, scene
from portbench.core.common import Outcome, Run, norm_gaps, reference_image
from portbench.core.trace import traced
from portbench.reference import train as reference_train

BETA1 = 0.9


def _epochs(rng: np.random.Generator, views: int, batch: int):
    perm, ptr = rng.permutation(views), 0
    while True:
        if ptr + batch > len(perm):
            perm, ptr = rng.permutation(views), 0
        yield perm[ptr:ptr + batch]
        ptr += batch


def _to(params: dict, device) -> dict:
    return {k: v.detach().to(device, copy=True) for k, v in params.items()}


def run(r: Run) -> Outcome:
    from fourdgs_tpu_torch.data.scene import ImageBank
    from fourdgs_tpu_torch.render.render import render
    from fourdgs_tpu_torch.train import graphs, loop

    dev, config, mix = r.device, r.config, r.mix
    pub, assumed = config["published"], config["assumed"]
    w, h = r.size
    cfg = program.load_config(config)
    r.mark("imports")
    truth, fixed = scene.true_scene(config, r.seed, dev)
    start = scene.trained_state(config, truth, r.seed, dev)
    bank = [cameras.to_tensors(c, dev) for c in cameras.bank(
        assumed["rig"], mix["views"], assumed["time_frames"], w, h)]
    gts = torch.stack([reference_image(truth, fixed, config, c, "fp32")
                       for c in bank])
    del truth
    r.mark("scene_and_targets")
    state, tx = program.train_state(cfg, start, fixed, assumed["adam_count"],
                                    assumed["spatial_lr_scale"], dev)
    start_host = _to(start, "cpu")
    del start
    if r.fault == "unchanged":
        tx = tx._replace(update=lambda grads, st, params: st)
    pcams = [program.camera(c) for c in bank]

    def eager_render(rc, cam):
        with torch.no_grad():
            p = state.params
            return render(p["gauss"], p["deform"], cam, fixed["bg"], rc,
                          state.aabb, state.alive, pub["sh_degree"])
    rc, grown, use = program.grow_caps(program.raster_config(cfg, config),
                                       eager_render, pcams,
                                       fixed["alive"].shape[0])
    r.mark("state_and_caps")
    batch = pub["batch_size"]
    reg = (pub["time_smoothness_weight"], pub["l1_time_planes"],
           pub["plane_tv_weight"])
    key = graphs.StepKey("fine", fixed["alive"].shape[0], rc, False, batch,
                         float(pub["lambda_dssim"]), reg, graphs.switches())
    step_of = loop.step_of_key(tx)
    if r.fault == "half_batch":
        inner = step_of

        def step_of(k):
            fn = inner(k)
            half = max(batch // 2, 1)
            return lambda st, cams, g, bg, sh: fn(st, cams[:half], g[:half],
                                                  bg, sh)
    captured = dev.type == "cuda"
    programs = graphs.StepPrograms(step_of) if captured else None
    eager = None if captured else step_of(key)
    images = ImageBank("device", dev, images=gts)
    sh = torch.full((), pub["sh_degree"], dtype=torch.int32, device=dev)
    order = _epochs(np.random.default_rng(r.seed), len(bank), batch)
    fails = torch.zeros((), dtype=torch.int64, device=dev)

    def step(idxs):
        with record_function("next_view"):
            cams = [pcams[int(i)] for i in idxs]
            g = images.batch(idxs)
        with record_function("replay"):
            if captured:
                aux = programs.run(key, state, cams, g, fixed["bg"], sh)
            else:
                aux = eager(state, cams, g, fixed["bg"], sh)
        nonlocal fails
        fails = fails + ((aux.dropped_pairs > 0) | (aux.dropped_tile > 0)
                         | ~torch.isfinite(aux.loss)).long()
        return aux

    # the first steps, which the reference follows
    checked = [next(order) for _ in range(mix["check_steps"])]
    losses, first_grad = [], None
    for s, idxs in enumerate(checked):
        losses.append(step(idxs).loss)
        if s == 0:
            first_grad = {k: v.detach().cpu() / (1 - BETA1)
                          for k, v in program.named_first_moment(
                              state).items()}
    after = _to(program.named_params(state), "cpu")
    r.mark("checked_steps")
    for _ in range(mix["warmup_steps"]):
        step(next(order))
    r.mark("warmup")
    attempted = len(checked) + mix["warmup_steps"]

    outcome_metrics, trace = {}, None
    if not r.trace:
        t_start = time.perf_counter()
        setup_s = t_start - r.t0
        steps = 0
        while True:
            step(next(order))
            steps += 1
            if time.perf_counter() - t_start >= r.seconds:
                break
        with record_function("sync"):
            _sync(dev)
        elapsed = time.perf_counter() - t_start
        attempted += steps
        if captured:
            outcome_metrics = {
                "train_rays_per_s": (steps * batch * w * h / elapsed,
                                     "rays/s"),
                "setup_s": (setup_s, "s")}
    else:
        before = _to(program.named_params(state), "cpu")
        traced_views = []

        def loop_fn():
            for _ in range(mix["trace_steps"]):
                idxs = next(order)
                traced_views.append([int(i) for i in idxs])
                step(idxs)
            with record_function("sync"):
                _sync(dev)
            return len(traced_views)
        if captured:
            n, trace = traced(loop_fn)
        else:
            n = loop_fn()
        attempted += n
        end = _to(program.named_params(state), "cpu")
    failed = int(fails)
    peak = torch.cuda.max_memory_allocated(dev) if captured else 0
    del programs, eager, images, state
    if captured:
        torch.cuda.empty_cache()

    # the reference after the window
    r.mark("window")
    spec = scene.deform_spec(config)
    opt = {k: pub[k] for k in ("position_lr_init", "position_lr_final",
                               "position_lr_max_steps",
                               "deformation_lr_init", "deformation_lr_final",
                               "grid_lr_init", "grid_lr_final", "feature_lr",
                               "opacity_lr", "scaling_lr", "rotation_lr")}
    opt["spatial_lr_scale"] = assumed["spatial_lr_scale"]
    start_dev = _to(start_host, dev)
    batches = [([bank[int(i)] for i in idxs], gts[torch.as_tensor(
        idxs, device=dev)]) for idxs in checked]
    common = (spec, fixed["aabb"], fixed["alive"], batches, fixed["bg"], w,
              h, pub["tile_size"], reg, opt, assumed["adam_count"])
    ref = reference_train.follow(start_dev, *common, "fp32")
    if r.control:
        ctl = reference_train.follow(start_dev, *common, r.control)
        p_losses, p_grad, p_change = (ctl["losses"], ctl["grads"],
                                      ctl["change"])
    else:
        p_losses = [float(x) for x in losses]
        p_grad = {k: v.to(dev) for k, v in first_grad.items()}
        p_change = {k: after[k].to(dev) - start_dev[k] for k in after}
    r.mark("reference")
    compared, worst = _compare(p_losses, p_grad, p_change, ref,
                               r.cell["limits"])

    metrics, busy, window, breakdown = outcome_metrics, None, None, None
    notes = {"caps": {"tile_cap": rc.tile_cap,
                      "bin_pairs_per_chunk": rc.bin_pairs_per_chunk,
                      "grown": grown, **use},
             "worst_leaf": worst, "losses": p_losses,
             "reference_losses": ref["losses"], "phases": r.phases}
    if r.trace and trace is not None:
        evals = []
        for state_host in (before, end):
            params = _to(state_host, dev)
            per = {}
            for i in sorted({i for v in traced_views for i in v}):
                per[i] = reference_image(params, fixed, config, bank[i],
                                         "fp32", with_counts=True)[1]
            evals.append(per)
            del params
        views = [[((evals[0][i].evaluated + evals[1][i].evaluated) / 2,
                   (evals[0][i].contributing + evals[1][i].contributing) / 2)
                  for i in v] for v in traced_views]
        n_live = assumed["gaussians"]
        flops = sum(work.step_flops(spec, n_live, v, w * h) for v in views)
        ev = sum(e for v in views for e, _ in v)
        co = sum(c for v in views for _, c in v)
        notes["evaluations_start_end"] = [
            sum(evals[0][i].evaluated for v in traced_views for i in v),
            sum(evals[1][i].evaluated for v in traced_views for i in v)]
        metrics = {"trace": trace, "flops": flops,
                   "blend_fwd_bound_s": work.seconds_at_peak(
                       work.blend_fwd_flops(ev, co)),
                   "blend_bwd_bound_s": work.seconds_at_peak(
                       work.blend_bwd_flops(ev, co))}
        busy, window, breakdown = trace.busy_s, trace.window_s, \
            trace.breakdown()
    return Outcome(attempted=attempted, failed=failed, metrics=metrics,
                   compared=compared, memory_peak_bytes=peak, busy_s=busy,
                   window_s=window, breakdown=breakdown, notes=notes)


def _compare(p_losses, p_grad, p_change, ref, limits):
    """The compared numbers with their limits, and what else was read.

    `loss_gap`: the first step's loss against the reference's, relative.
    `grad_gap`: the worst leaf's gap of first-gradient norms. `change_gap`:
    the median leaf's gap of norms of the change after the checked steps.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out (they move under Adam by round-off). The later
    steps' losses and the worst leaf's change are kept in the notes only:
    Adam's first update from zero moments moves every element by the same
    step whatever its gradient's size, so elements whose gradient is below
    the sums' rounding move either way, and those two numbers carry that
    noise (PERF.md)."""
    r_losses = ref["losses"]
    finite = (len(p_losses) == len(r_losses) and all(np.isfinite(p_losses))
              and all(np.isfinite(r_losses)))
    gaps = [abs(p - q) / abs(q) for p, q in zip(p_losses, r_losses)] \
        if finite else [float("inf")]
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in ref["grads"].items()}
    med = sorted(norms.values())[len(norms) // 2]
    counted = [k for k, v in norms.items() if v >= 1e-3 * med]
    grad = norm_gaps(p_grad, ref["grads"], counted)
    change = norm_gaps(p_change, ref["change"], counted)
    worst_grad = max(grad, key=grad.get)
    worst_change = max(change, key=change.get)
    return ({"loss_gap": (gaps[0], limits["loss_gap"]),
             "grad_gap": (grad[worst_grad], limits["grad_gap"]),
             "change_gap": (float(np.median(list(change.values()))),
                            limits["change_gap"])},
            {"grad": worst_grad, "change": worst_change,
             "worst_change_gap": change[worst_change],
             "loss_gaps_by_step": gaps,
             "counted_leaves": len(counted), "leaves": len(norms)})


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

