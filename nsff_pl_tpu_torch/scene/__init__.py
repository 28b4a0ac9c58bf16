"""Scene layer (port of `nsff_pl_tpu/scene`): COLMAP I/O, pose math, PNG,
PFM and flow I/O on numpy and the standard library, and the monocular
scene loader, whose ray table lives on the device."""

from nsff_pl_tpu_torch.scene import colmap, depthio, flowio, imageio, poses  # noqa: F401
from nsff_pl_tpu_torch.scene.monocular import MonocularScene  # noqa: F401

scene_dict = {"monocular": MonocularScene}
