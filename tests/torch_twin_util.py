"""The port's half of the tiny twin model of `torch_train_util`: a conv,
batch norm, mean pool and Dense head with the JAX twin's parameter
names. Torch only, so processes that run the port alone (the ranks of
`torch_dist_util`) import it without JAX."""

import torch

from deepvariant_tpu_torch.models import inception_v3 as iv3

TWIN_SHAPE = (17, 23, 7)
TWIN_FEATURES = 8


class TorchTwin(torch.nn.Module):
    """The port's twin of `JaxTwin`, with the same parameter names."""

    def __init__(self, channels: int = TWIN_SHAPE[2],
                 dropout_rate: float = 0.0, bn_momentum: float = 0.9,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem = iv3.ConvBN(channels, TWIN_FEATURES, (3, 3), 4, "VALID")
        self.stem.bn.momentum = bn_momentum
        self.classification = torch.nn.Linear(TWIN_FEATURES, 3)
        self.dropout_rate = dropout_rate
        self.dtype = dtype

    @property
    def compute_dtype(self):
        return self.dtype

    def forward(self, x, generator=None):
        x = self.stem(x.to(self.dtype).permute(0, 3, 1, 2))
        h = x.mean(dim=(2, 3), dtype=torch.float32).to(x.dtype).float()
        if self.training and self.dropout_rate > 0:
            h = iv3.dropout(h, self.dropout_rate, generator)
        return torch.softmax(self.classification(h), dim=-1)
