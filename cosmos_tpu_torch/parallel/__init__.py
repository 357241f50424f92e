"""Scaling over ``torch.distributed`` (counterpart of ``cosmos_tpu/parallel``):
the process group (``distributed``), the meshes (``mesh``), tensor
parallelism (``tp``) and FSDP (``fsdp``)."""
