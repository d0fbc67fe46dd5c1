"""The plain reference that decides ``correct``: plain PyTorch in fp32
with TF32 off, importing nothing of the port."""
