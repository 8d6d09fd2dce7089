"""Multi-process data contract: which slice of a global batch this process
loads (`distributed.process_local_batch_slice`). Data- and fully-sharded
training over `torch.distributed` is not ported yet."""
