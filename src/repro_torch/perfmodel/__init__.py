"""The paper's analytical S2TA performance model (port of
``repro.perfmodel``): its design points and CNN workloads, plain Python."""
