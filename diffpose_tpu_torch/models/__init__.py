from diffpose_tpu_torch.models.denoiser import GCNDiff
from diffpose_tpu_torch.models.igcn import IGCN
from diffpose_tpu_torch.models.lifter import GCNPose

__all__ = ["GCNDiff", "GCNPose", "IGCN"]
