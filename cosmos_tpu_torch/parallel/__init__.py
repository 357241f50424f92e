"""Data parallelism over ``torch.distributed`` (counterpart of
``cosmos_tpu/parallel``; only the data axis is ported)."""
