"""Core algorithms: status tuples, priorities, MIS-2 and coarsening."""
