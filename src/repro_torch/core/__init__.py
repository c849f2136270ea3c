"""LSGD training of the port: topology, the virtual Algorithms 1-3, the
gradient sync modes on ``torch.distributed`` and the trainer."""
