"""The port's command lines: one module per root tool of the JAX
package (`tools/<name>.py`), each with ``main(argv=None) -> int``, the
root tool's arguments, exit codes and JSON-line keys, and ``--device``
(default ``cuda``) wherever it runs the engine.  Run them as

    python -m wittgenstein_tpu_torch.cli.<name> ...

`wittgenstein_tpu_torch/tools/` stays the port of the JAX package's
own `tools/` subpackage (csvf, graph, node_drawer).
"""
