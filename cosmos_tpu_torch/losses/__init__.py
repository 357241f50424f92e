from .contrastive import ClipLoss, COSMOSLoss

__all__ = ["ClipLoss", "COSMOSLoss"]
