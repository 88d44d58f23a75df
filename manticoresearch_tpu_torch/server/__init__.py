"""Servers: the agent tier of distributed tables (``agent.py``)."""
