"""Model zoo of the port: attention + MLP and RWKV-6 decoder stacks (see ``transformer``)."""

from repro_torch.models.transformer import Model, build_model  # noqa: F401
