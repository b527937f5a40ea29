"""Entry points of the port beyond the solvers: the ensemble serving
loop (``repro_torch.launch.serve_sim``), and language-model serving
(``serve``, on the step makers of ``steps``)."""
