"""Sharded renders over ``torch.distributed`` (``shard``)."""
