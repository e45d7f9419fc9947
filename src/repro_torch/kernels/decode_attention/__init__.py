"""int8 KV-cache decode attention, dense and paged (``ops.py``)."""
