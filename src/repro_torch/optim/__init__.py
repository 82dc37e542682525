from .optimizer import (OptConfig, apply_updates, init_opt_state,
                        opt_state_specs, schedule)

__all__ = ["OptConfig", "apply_updates", "init_opt_state",
           "opt_state_specs", "schedule"]
