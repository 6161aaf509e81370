"""The plain reference that decides ``correct``: a float32 forward in plain
PyTorch (``decoder``) and the comparison of served tokens with it
(``judge``). Nothing here imports the program under test."""
