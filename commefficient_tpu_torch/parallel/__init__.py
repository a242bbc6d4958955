"""The multi-device layer of the port: the rank layout over
torch.distributed (mesh.py), the process runtime (multihost.py),
Megatron-style tensor parallelism (tp.py), the control plane's plan
transport (plantransport.py), ring attention (ring.py) and the
spawnable grid worker (mh_worker.py). The port of
commefficient_tpu/parallel/."""
