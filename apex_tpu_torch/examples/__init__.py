"""Port twins of the repo's ``examples/`` scripts, run as modules
(``python -m apex_tpu_torch.examples.<name>``)."""
