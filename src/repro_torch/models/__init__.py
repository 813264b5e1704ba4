"""Model zoo of the port: attention + MLP decoder stacks (see ``transformer``)."""

from repro_torch.models.transformer import Model, build_model  # noqa: F401
