"""Config files of the port's `sft` CLI (`python -m xtuner_tpu_torch.train.cli.sft
--config xtuner_tpu_torch/recipes/<name>.py`), and `bench_longctx_64k.py`,
bench.py's longctx row for `TrainEngine`."""
