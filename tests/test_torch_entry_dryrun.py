"""``dryrun_multichip`` at P = 4 on the CPU, its ranks ``LocalRing`` threads
(the port's ``entry`` and the P = 2 dry run: ``test_torch_entry.py``)."""

from md_neighbor_list_tpu_torch.entry import dryrun_multichip
from torch_port_util import check_dryrun


def test_dryrun_multichip_p4_passes_its_gates(capsys):
    check_dryrun(dryrun_multichip(4, device="cpu"), 4,
                 capsys.readouterr().out)
