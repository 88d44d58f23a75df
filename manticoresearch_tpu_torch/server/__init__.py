"""Servers: the listeners of the daemon (``mysql.py``, ``http.py``,
``api.py``, ``daemon.py``), the agent tier of distributed tables
(``agent.py``) and replication (``repl.py``, ``cluster.py``)."""
