"""The port's data layer: federated CIFAR, EMNIST, ImageNet and
PersonaChat datasets, the uniform client sampler and the round-batch
loaders (host-side numpy)."""
from commefficient_tpu_torch.data.fed_dataset import FedDataset  # noqa: F401
from commefficient_tpu_torch.data.sampler import (  # noqa: F401
    FedSampler, RoundIndices, ValSampler,
)
from commefficient_tpu_torch.data.loader import (  # noqa: F401
    FedLoader, FedValLoader,
)
from commefficient_tpu_torch.data.cifar import (  # noqa: F401
    FedCIFAR10, FedCIFAR100,
)
from commefficient_tpu_torch.data.emnist import FedEMNIST  # noqa: F401
from commefficient_tpu_torch.data.imagenet import FedImageNet  # noqa: F401
from commefficient_tpu_torch.data.persona import FedPERSONA  # noqa: F401
from commefficient_tpu_torch.data import transforms  # noqa: F401
