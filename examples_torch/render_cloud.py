"""Example: render a .ply cloud with the differentiable splatter, on the
PyTorch/CUDA port.

The counterpart of ``examples/render_cloud.py``: a PNG through matplotlib,
or a raw PPM beside the requested name when matplotlib is missing. It runs
on the card unless ``--device cpu`` is given.

    python examples_torch/render_cloud.py input.ply output.png [image_size]
"""

import argparse

import numpy as np
import torch

from pytorch_points_tpu_torch.geo import Camera, render_points
from pytorch_points_tpu_torch.utils import pc_utils


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("image_size", type=int, nargs="?", default=256)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to render on")
    args = ap.parse_args()
    dev = torch.device(args.device)
    inp, out, size = args.input, args.output, args.image_size
    xyz = pc_utils.read_ply(inp)
    xyz, _, _ = pc_utils.normalize_point_cloud(xyz)
    # color by height
    t = (xyz[:, 1] - xyz[:, 1].min()) / max(np.ptp(xyz[:, 1]), 1e-6)
    colors = np.stack([t, 0.4 + 0.2 * t, 1.0 - t], -1).astype(np.float32)
    with torch.inference_mode():
        img, alpha = render_points(
            torch.from_numpy(xyz).to(dev)[None],
            torch.from_numpy(colors).to(dev)[None],
            camera=Camera(eye=(1.5, 1.5, 2.5), focal=1.8),
            image_size=size,
            splat_radius=0.01,
        )
    arr = (np.clip(img[0].cpu().numpy(), 0, 1) * 255).astype(np.uint8)
    try:
        import matplotlib

        matplotlib.image.imsave(out, arr)
    except Exception:
        # raw PPM fallback
        with open(out.rsplit(".", 1)[0] + ".ppm", "wb") as f:
            f.write(f"P6 {size} {size} 255\n".encode())
            f.write(arr.tobytes())
    print(f"rendered {xyz.shape[0]} points -> {out}")


if __name__ == "__main__":
    main()
