"""Runs of the port's paths: the SkyQuery cell (``skyquery``), the kill -9
recovery drill of the service daemon (``smoke_recovery``), and the
reference's drivers and gates (``common``, ``fig2_hybrid_join``,
``fig5_bucket_reuse`` ... ``fig8_tradeoff``, ``bench_*``,
``serving_bench``, ``kernel_bench``, ``ft_bench``; ``run`` drives them
all), each ``python -m repro_torch.benchmarks.<name> [--device cpu]``,
writing ``BENCH_torch_<name>.json``."""
