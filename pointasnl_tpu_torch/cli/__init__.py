"""Command-line programs of the port: ``python -m
pointasnl_tpu_torch.cli.train_scannet`` and ``...cli.test_scannet``. They run
on the card unless given ``--device cpu``."""
