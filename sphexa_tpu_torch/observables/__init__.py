from sphexa_tpu_torch.observables.conserved import (conserved_quantities,
                                                    format_constants_line)
