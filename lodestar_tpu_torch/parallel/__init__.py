"""The batch verifier: planner, marshalling and the grouped verdict."""
