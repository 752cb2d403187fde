"""Data parallelism over ``torch.distributed`` (the port's counterpart of
``uemda_tpu/parallel/``): ``mesh`` holds this rank's place in the group
and the collectives the steps take, ``multihost`` the process group, the
rank guards and the CLIs' launcher."""
