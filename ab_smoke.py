#!/usr/bin/env python3
"""chip_smoke.py's serving and training phases (3 and 5) from one tree, for
comparing two trees on one card in turns.

    python3 ab_smoke.py <tree root> <tag>

Imports `chip_smoke` and `fourdgs_tpu_torch` from <tree root> (a checkout,
or `git archive <commit>` unpacked under the git-ignored `build/`), builds
its kernels, serves the 100,000-Gaussian snapshot (phase 3) and replays its
24 frames three more times, then trains (phase 5); where the tree's
chip_smoke.py has phase 8's reassociation check, it runs it on phase 6's
step input. Every line it adds starts with "AB <tag>". To compare a parent
with a change, run parent, change, change, parent in one call:

    for side in parent change change parent; do
        python3 ab_smoke.py $(realpath build/$side) $side; done
"""
import os
import sys
import time
from pathlib import Path


def main(root: str, tag: str) -> None:
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as cs
    cs.phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cs.phase_build()
    work = Path(root) / "build" / f"ab_{tag}"
    work.mkdir(parents=True, exist_ok=True)
    scene = cs.make_scene(torch, 0, device)
    renderer, cams, *_ = cs.phase_slice(torch, scene, device, 24, work)
    for r in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in cams:
            renderer.render(c)
        torch.cuda.synchronize()
        print(f"AB {tag} frames round {r}: "
              f"{(time.perf_counter() - t0) / len(cams) * 1e3:.4f} ms/frame",
              flush=True)
    state, rc, bg, sh, cam, gt, _, _ = cs.phase_train(torch, scene, renderer,
                                                      device, 30, 0)
    if hasattr(cs, "check_reassociation"):
        from fourdgs_tpu_torch.ops import blend
        from fourdgs_tpu_torch.train import loop
        _, args, _, _ = cs.phase_kernels_bwd(torch, state, rc, bg, sh, cam, gt)
        got = blend.blend_backward_slots(*args)
        kw = dict(stage="fine", raster_cfg=rc, lambda_dssim=0.0,
                  reg_weights=(0.01, 0.0001, 0.0001))

        def grads():
            sg = loop.step_gradients(state, [cam], gt[None], bg, sh, **kw)
            return [x for x in sg.grads + [sg.ndc_grad] if x is not None]

        print("AB", tag, cs.check_reassociation(
            torch, args, got, state.params["gauss"], state, rc, sh, cam,
            grads, grads()), flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    main(os.path.abspath(sys.argv[1]), sys.argv[2])
