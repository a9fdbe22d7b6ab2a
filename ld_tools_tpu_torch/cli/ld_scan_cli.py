"""CLI for the port's ld_scan (a copy of ld_tools_tpu/cli/ld_scan_cli.py).

EN/RU help selected by the entry script like the other tools.  The
engine choice is {cuda, torch}: the hand-written kernels on the card, or
their plain PyTorch versions on the CPU.  There is no automatic choice,
so a run never falls back to the CPU without being asked to.
"""

from argparse import ArgumentParser, RawTextHelpFormatter

TEXT_EN = {
    "description": """
Whole-chromosome all-pairs LD threshold scan: streams billions of
variant pairs through the GPU and writes only pairs with LD above the
threshold (optionally within a distance window) as a pair-list TSV.

Version: {ver}
New capability of tpu-ld (the reference toolkit caps out near 500x500
matrices); LD math and threshold semantics are identical to ld_area.
License: MIT
""",
    "chroms": "Chromosomes to scan, comma-separated (default: all packed)",
    "trg_dir": "Path to target folder",
    "intgen_dir": "Path to folder for 1000G data",
    "skip_ver": "Do not check 1000G data completeness",
    "gends": "{male, female, both} Sample genders",
    "pops": "Sample populations (comma-separated)",
    "measure": "{r_square, d_prime} LD measure for the threshold",
    "thres": "Lower LD threshold",
    "max_dist": "Maximum pair distance in bp (default: unlimited)",
    "checkpoint": "Folder for per-batch scan checkpoints (resume after a kill)",
    "devices": "Shard scan tiles over this many local devices"
               " ('all' = every device; default: 1; at most the cards"
               " there are; -E torch: N CPU shards)",
    "engine": "{cuda, torch} Count kernels (cuda: hand-written kernels"
              " on the GPU; torch: their plain PyTorch versions on the CPU)",
}

TEXT_RU = {
    "description": """
Полнохромосомный скан LD по всем парам: миллиарды пар вариантов
проходят через GPU, в выходной TSV попадают только пары с LD выше
порога (опционально — в пределах окна дистанции).

Версия: {ver}
Новая возможность tpu-ld (референсный тулкит ограничен матрицами
~500x500); математика LD и семантика порога — как у ld_area.
Лицензия: MIT
""",
    "chroms": "Хромосомы для скана через запятую (по умолчанию: все упакованные)",
    "trg_dir": "Путь к целевой папке",
    "intgen_dir": "Путь к папке с данными 1000G",
    "skip_ver": "Не проверять комплектность данных 1000G",
    "gends": "{male, female, both} Пол сэмплов",
    "pops": "Популяции сэмплов (через запятую)",
    "measure": "{r_square, d_prime} Мера LD для порога",
    "thres": "Нижний порог LD",
    "max_dist": "Максимальная дистанция пары в bp (по умолчанию: без лимита)",
    "checkpoint": "Папка для почанковых чекпоинтов скана (возобновление после сбоя)",
    "devices": "Шардировать тайлы скана на столько локальных устройств"
               " ('all' = все; по умолчанию: 1; не больше, чем есть карт;"
               " -E torch: N шардов на CPU)",
    "engine": "{cuda, torch} Ядра подсчёта (cuda: написанные вручную"
              " ядра на GPU; torch: их простые версии PyTorch на CPU)",
}


def build_parser(ver: str, text: dict) -> ArgumentParser:
    parser = ArgumentParser(
        description=text["description"].format(ver=ver),
        formatter_class=RawTextHelpFormatter,
    )
    parser.add_argument(
        "-C", "--chroms", metavar="[all]", default="all", dest="chroms",
        type=str, help=text["chroms"],
    )
    parser.add_argument(
        "-t", "--trg-dir-path", metavar="str", required=True,
        dest="trg_dir_path", type=str, help=text["trg_dir"],
    )
    parser.add_argument(
        "-D", "--intgen-dir-path", metavar="str", dest="intgen_dir_path",
        type=str, help=text["intgen_dir"],
    )
    parser.add_argument(
        "-f", "--skip-intgen-data-ver", dest="skip_intgen_data_ver",
        action="store_true", help=text["skip_ver"],
    )
    parser.add_argument(
        "-g", "--gend-names", metavar="[both]",
        choices=["male", "female", "both"], default="both",
        dest="gend_names", type=str, help=text["gends"],
    )
    parser.add_argument(
        "-e", "--pop-names", metavar="[all]", default="all",
        dest="pop_names", type=str, help=text["pops"],
    )
    parser.add_argument(
        "-l", "--ld-measure", metavar="[r_square]",
        choices=["r_square", "d_prime"], default="r_square",
        dest="ld_measure", type=str, help=text["measure"],
    )
    parser.add_argument(
        "-z", "--ld-low-thres", metavar="[0.8]", default=0.8,
        dest="ld_low_thres", type=float, help=text["thres"],
    )
    parser.add_argument(
        "-w", "--max-dist", metavar="[None]", dest="max_dist", type=int,
        help=text["max_dist"],
    )
    parser.add_argument(
        "-k", "--checkpoint-dir", metavar="[None]", dest="checkpoint_dir",
        type=str, help=text["checkpoint"],
    )
    parser.add_argument(
        "-d", "--devices", metavar="[1]", dest="devices",
        type=str, help=text["devices"],
    )
    parser.add_argument(
        "-E", "--engine", metavar="[cuda]",
        choices=["cuda", "torch"], default="cuda", dest="engine",
        type=str, help=text["engine"],
    )
    return parser


def add_args_en(ver, argv=None):
    return build_parser(ver, TEXT_EN).parse_args(argv)


def add_args_ru(ver, argv=None):
    return build_parser(ver, TEXT_RU).parse_args(argv)
