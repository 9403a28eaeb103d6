"""The JAX package's examples on the port (``python -m
monte_carlo_localization_tpu_torch.examples.<name>``): ``localize_on_map``
(global localization on a real map), ``fleet_racing`` (16 cars through the
fleet step) and ``fleet_live_loop`` (8 cars through ``FleetNode`` and a
``LiveRunner``). Each runs on the card unless given ``--device cpu``."""
