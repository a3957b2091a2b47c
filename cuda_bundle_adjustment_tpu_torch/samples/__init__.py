"""Sample programs of the port, run as modules::

    python -m cuda_bundle_adjustment_tpu_torch.samples.sample_ba_from_file GRAPH.json
    python -m cuda_bundle_adjustment_tpu_torch.samples.sample_comparison_with_cpu GRAPH.json
    python -m cuda_bundle_adjustment_tpu_torch.samples.sample_distributed_schur [D] [N]

All run on the CUDA card unless ``--device cpu`` (the distributed sample:
``--cpu``) is given.
"""
