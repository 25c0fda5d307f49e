"""The repo's examples (``examples/*.py``) run on the port, each a module:
``python -m ai4e_tpu_torch.examples.<name>`` with the same arguments and
the same printed output as the JAX package's script.

- ``echo_service``: the echo API in one process (``APIService.run``);
- ``async_platform``: gateway, task store, broker, dispatcher and a
  scoring backend in one process;
- ``loadgen``: the closed-loop load generator against a live gateway;
- ``streaming_pipeline``: a two-stage streaming DAG of two small LMs under
  one TaskId, its chunks read over SSE (the LMs on ``cuda`` unless
  ``--device cpu``).
"""
