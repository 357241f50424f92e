from .contrastive import (ClipLoss, CoCaLoss, COSMOSLoss, DistillClipLoss,
                          SigLipLoss)

__all__ = ["ClipLoss", "CoCaLoss", "COSMOSLoss", "DistillClipLoss",
           "SigLipLoss"]
