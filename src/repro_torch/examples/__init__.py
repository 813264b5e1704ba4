"""The example scripts of ``examples/``, ported: each imports only
``repro_torch``, torch, numpy and the standard library, and runs as
``python -m repro_torch.examples.<name>``.

- ``quickstart``, ``policy_sweep``, ``fleet_routing``: the simulator through
  ``repro_torch.api``, no device work, deterministic per seed; the committed
  ``examples/specs/*.json`` run on the port's cards (``h100``, ``h100_half``).
- ``spacetime_ablation``, ``multi_tenant_serving``, ``train_small``: drive the
  card (K1; K3 and K4; K4 or K5 forward and backward) and take ``--device
  cpu`` to run the kernels' plain versions instead.
"""
