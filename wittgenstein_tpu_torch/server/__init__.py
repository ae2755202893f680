"""The server plane of the port: so far only the parameter gate
(`server/core.py`); the `Server`, HTTP and external-node bridge wait
for ROADMAP.md A14."""
