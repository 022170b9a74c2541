"""Command-line programs of the port, one a JAX package CLI: ``python -m
pointasnl_tpu_torch.cli.<name>`` for the train and test drivers of ModelNet40
(``train_modelnet``, ``test_modelnet``), ScanNet (``train_scannet``,
``test_scannet``, and the grid pair), SemanticKITTI (``train_semantic_kitti``,
``test_semantic_kitti``, and the grid pair) and the scan viewer
(``visualize_semantic_kitti``). The drivers run on the card unless given
``--device cpu``."""
