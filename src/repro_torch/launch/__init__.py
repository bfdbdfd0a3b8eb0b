"""Entry points of the port: ``launch/train.py`` (federated LM
training). Serving waits for the port of decode."""
