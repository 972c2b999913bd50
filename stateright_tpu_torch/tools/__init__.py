"""The port's command-line tools, run as ``python -m
stateright_tpu_torch.tools.<name>``: ``service_chaos``, the chaos/load
harness of the checker service and its fleet; ``mesh_worker``, one rank of
the sharded engine's mesh over several processes."""
