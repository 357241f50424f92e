from .contrastive import ClipLoss, COSMOSLoss, DistillClipLoss, SigLipLoss

__all__ = ["ClipLoss", "COSMOSLoss", "DistillClipLoss", "SigLipLoss"]
