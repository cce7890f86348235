"""The plain reference of a sketch window (`sketch.py`), its frozen hash
arithmetic (`hashing.py`), the comparison that decides `correct`
(`judge.py`) and the control one precision lower (`control.py`). Plain
PyTorch and NumPy: nothing of the program, nothing of JAX."""
