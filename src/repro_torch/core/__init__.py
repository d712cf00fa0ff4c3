"""The decoupling runtime of the port: groups, stream channels and their
wire, decoupled collectives, stream operators, the dataflow executor, the
paper's performance model and the imbalance models."""
