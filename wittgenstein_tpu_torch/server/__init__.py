"""The server plane of the port: the parameter gate and the interactive
`Server` (`server/core.py`), and its HTTP face with the batch routes
(`server/http.py`, ``python -m wittgenstein_tpu_torch.server.http``)."""
