# Distribution substrate: a device mesh that shards the fleet plane's lanes
# in one process, or a model over a torch.distributed world of processes.
