"""The AV1 specification's constant tables that an intra frame reads.

Default CDFs (section 9.4's Default_*_Cdf arrays), stored packed: for each
table, row after row, the N - 1 values 32768 - cdf[i] of an N-symbol
alphabet, as little-endian uint16 in one zlib stream. `default_cdfs(qctx)`
unpacks them into the rows the symbol decoder adapts: a list
[32768 - cdf[0], ..., 32768 - cdf[N - 2], 0, count]. The coefficient
tables keep their four quantiser contexts until `default_cdfs` picks one.

The other tables: Dc_Qlookup and Ac_Qlookup at 8 bits, the smooth
predictors' weights (Sm_Weights_Tx_4x4 ... 64x64, one after the other),
Dr_Intra_Derivative indexed by angle (zero at angles no mode reaches), and
Intra_Filter_Taps[5][8][7]. The scans, the block and transform size tables
and the small lookups follow the specification's definitions.
"""

from __future__ import annotations

import base64
import functools
import zlib

import numpy as np

_CDF_BLOB = (
    "eNrtvGdUYtm2Nrw3OYkSxQSCgiAIKEFQQVHAhGACQVQUxBwxx8q5K+ecQ1dVV87Ryl05duWcuyvnXP3at8+9o8/o"
    "8+Md3xnnz3ffscde6JxzrzWftdea85kLh4FJPapWKSJSLhodsTdcyh7C/EKw47+jfLLqlAcl68UEUZxgYDiKMy4Y"
    "7xOKMcF3WZ+ZH3O/cl6xleydzKcBZ/wqvHyx62HvUs4lHY4fKU+QLZPcjVzHszDqcURkFLgsU2TwShoTb4reGzmK"
    "SwjcSTuOno9gg1esAyQThAmCbeG0sNNsHuta4Er8c5QUvrDiBtMn+BidSlcFHPE/SuOQRdgL8FPQp06SURSJEq2K"
    "mMkv400OrQ5+RyzC30ctL5qv35akUQFxMCVNMT5qK4OBH4kQQkY5K1Pak3YneMeQRMHhccH1/hTcFwQCutP4a1qH"
    "ABd+mXs6bHookz4gYB5uPnojhJfvTN8SfVdaI8mI5InO8TLYC0kPvHTIK+XTy6z+zX4Qvz00OVVNaPH5htqCXAlh"
    "WcKzp+m2xblivyoHRD/j72Cdxa9HwyDUgl7bmPiJcShFkOwQf7p/PG0k5gUyEjxs3Jc8MEmiWCYfK30bZRYE0gFc"
    "LLIcfOeApmmTRao7sRHKQMVbSVvQeVwaYiX4reibrVRHiV2iRCoGy27y7zES8YMxzyE3S1YUXMh/oDap56l+j1sv"
    "H+Wbjj4Dewm0FF7Oo+XwtW/VvyoLZIlheQG/Yz4hAsCbxplpUzVqdY/MJJRwpgdO9fuMzkaEgEvzD6fRdE81S2IG"
    "CTW8XOb1QD7OhngCFjhiC8Wx6xRV0tbIHWFL/efRpNhDqC/gT+YrWbsMFs1w1SjlNxkj7ArjNK4QSQfVzgWOHtsb"
    "y8MkRvQozgxvGH4Y/DB0LdDdZq1pdKLCJlM/oKFttKr5hZrQRdTh6LjG97k9aWXSX9jH4AF1nNxftHjVlnASIboj"
    "y5yT3C0JC6v0ntGSYI014WMX8O+gEtpW5C5OGiO+FYb1ftKozTOb3sbAIjSomWErmDcDDwT0+lfQsqjPiKsJUzEh"
    "yDDopfzfqYup+VQi9SVpKSmTpCTsxc3AnoCOselsaJ/b3qu8p3i/9hqMdWIvIG9B70G2p21NXZriFfQ5YFDAfP+3"
    "FIdPDWoYnARet021yW1028XAHOoxIo74E2EIAoBNBU9nPUmbnFaRptDd8xrj9Rz3CpuMEMGvAgtT9iUHx6erj8VM"
    "jOnwQWGuoRdDV4JuYFUGMaNX5590JLE78UyCAv+TVwYqDCoBEVmL006lRmt7kyYlDtPUJzzwMaDPIovBKbKBUXNF"
    "BqEzgi0YEq4J62QneZvRWRBVdLyEKAyKwAl+Dk/lrWf7heZQ7fAaSK/qoOxe5FjxNNHEiNmC2nAh97J/Dm0zdEmm"
    "Jm2irkFXopPp/HX7tZXatkSbhhVvy1PkzskYYgDTFqac1F1OHKcZHfktIpVbwzTU7YpaHomOlIrXR0RGyAQ/8QqY"
    "YxgV1Nu48upvVaLIc2KHmCfmCzX81+Hz2AnMQYyjvqvdYCnRuS1FkRyv1+tmq1WKl/xE3uLQ0cxhNajqyxWGCots"
    "qXh+OInXwl1Pvx5o9v9IQ1T7ute7GK6H+cMjygRIfki4lHExsJp2mSKunV9z3eV0HSikF0b3R6Tdwhp2REhH8BS6"
    "uGy1e23R8oJL9mb7J1uLfKysj1vALmWFMSZVwF2zSwIKr9g35j+ymfKEchZ3LlvL6PIvsNzM+Wx0ZbxP/zmNm1qq"
    "y06iiu6F14beoz+0vM/+aCzM2JMekWZP6dHe1XRGWsNYIcSAsVaVZaERmbElfX7a+ZRD2qeJoRKEmBk6MmhbE7Mm"
    "3LXOmed8XzKiZGDxZcdte63tkWUkXivLD0xBz0htjBrqQzUNCuH7WG0L5dAAUlK8EB68xvclqdrbgZuKckKxJTdy"
    "69Ux3EJWBP2B7z3vVuzVKr7hk/ajaAXXEBwfGOw3BjKrhVOeXzRU+IYtZ+yipZNUiLvRKcLVbJC8mzACvx5Hx/wM"
    "+1Ayp+BxZjH9YMAOv+3UNuJQ/KCK0wUbrMHBewNNNA21k3wWMq6zuI3cEuPThX+Ia8D6YtzQvMhf+FfZg3FN2OPo"
    "g6hcJBm2yb3H+Sj/MnEZYa7PJXwirgJzpILgLHW8807CH8dOwCxDEyGzurVdkZ0sRBF8JQyEtUE3gXDSIcJ4n0Dw"
    "ATAVGARElm0o3eQ4CGFD1oBjweNVT93C0geQIMgzYAeg7InprulKAB8C04EKAOycW4y1RxrNoSbSiZ5PHlL+aDNT"
    "mUgs7slqWtIYlcWT/sguqT6QOihpqNIv9AJ6e52+4nRxZt7igHFeUZ319Th7vmVb/DlSau9vzWrPWnerUh6S39VW"
    "j66tyj4iPhL8pItbryzKsgqiK73kA6oaW2p7XX4qMUvTy60vdBsKWzWnWE96X9R1VEcXro0HeWs9B6tmWghJfhIa"
    "a0N7dpo6eVw8J+QUaUfvksLLej/dNukicmBvhfN2ydRknmxf2KwusvZXzSBVsXA7urEHUzug+lHFT7zvlGedh8vS"
    "C7fYv+nKA4/2ZlVnVgW4KZqGsLHdw4o3OBC5bXHn+QE9pc5Z9ul5Z9Sj8ZMGEF2UEkpBnuZW6NTeq8VNdpPlTWJZ"
    "cPkApjOzWGyTae9Hpnq05a5cP+0w6cWQsrKTBolklt//Xz5ndr3OwIUtJdcPmO6WZv3iO60XrHRmr1IP6J2sdUcH"
    "oB4NmNe8iA2SDg4YXReQncq6NuCrJytZIXANyCwnZ9yJHTVgn3tahsDr7ABH1W0jXPCmV1uByN3M/mkAoYqRtSku"
    "s91Qhc4aG813EkR5cAZYD2QCBiAF0AIJQBygAKSAGBAA95JPhvgRExA2SAvoBx4ApgAdQClQDBQAViAXeJs9hXvP"
    "ZyB8MfgO2Aa0AQ7ADuQBOYAJSAeSgUlUC/wheOhf9MoFQoEFcXJ/mncDaiu8CzoYshdsBcXgV+AM0AesBSYBdfps"
    "fkYAlLQAvwj9FTEX2gBxgR+BNf2aBqAGAKL6L6ZPZijmjxsbPRCpz9ik/eMmMr8HVFVG5PxxF6r9wt7U/uj+UqEv"
    "+WQ02keaQlIExu3cflf+56IbB+Z9Eacr/+s34kiIHfh7O1ADZAyUD9QOzBgY93/z817V9rhY519HGSKDcvem/1Vi"
    "Eg9Qnc/YmvE65b8l0aIQUZ02T7dO99+S+ayLcRcT7sR8T1Unfs38Q1LJ2ifcKNucwIrpS6Fm/SH5RFYmVCoHSrxF"
    "gGKGJN86u3AOfb4QnnVXLY/6roXE8tJWe08KXRXeP/UJCtULozVuGHe44K+e/HntiwUjF+f8VTJRXMin6/8qiRKn"
    "iT4lbVHt/R/pbN5bHifaonmj+W9JG/dpxM1Er7jJSaTIo5I/JKVMMXdrTKB8l5SsKJX/IenwXybeHcOShEW7466G"
    "N8W+TgyjhQjE4u0x66Q92q1iJXcnnkS7nLNSnRnfKwwMzY9ypV9g/93nK7Lbomu6v0qGR+KknXF/lahkBMErWbaw"
    "Xvbfkp9FKaJ6UYbs9f88OSIKItgY+4vYpLgV6v9fc/OI1xp6K3KLiCc0RcqT/pC8DJ3J98S/kY1TYuSpzEeqFFUE"
    "bQNdEr0iqkBcYnuYiMHUM0ZT56uzY6jyQxJpdHpccWJv2N99FkUeF14V/1ViFYwSjgv9q+S1eG8ET7aXq4n8b4kr"
    "cr1Ixn/MTf8fbAFRZ0UsAY87S7KGO/W/+gsOy6Yf4m3jb4rR899J/5CoBSu526N3i32jzgn0EQrpQcs2xhh6oGg+"
    "64loZX6k3YU+LhX7r+G5JOdFulhq/AvReVl50t99ng79WrEuMyt8r3gt2Q/0d76Q3Mb42m6ix0AOwt501Flfqkui"
    "4/weAQ+qMpUnMX8+8wXzqmqU8nVICZcVEAtRN9K0x/H/6C/mYfs4V3KQ2bwHNgFY2fk2EYKuG/C2Og9WUD5mwKyO"
    "8W1Agtl8Bf1XDwrRdc65hldCX6GO+gYyquo35UjCn5qr0Avt8Za42NH8weRGcHddfkLyPzQu6Pa8QUp/Bor9nngZ"
    "HFXfnJj+D80s3yddqdmTRMOjx/mroZFVewVRXgN6kLxQOJemHdBYqAwu44xCLQD+6kE2bkrB0Iw1kq0xvzCMqF/r"
    "yzRHAv7U8KHOpvpcmTIr0krDQ6nN7/S7g/7UTAXjLHWya8HDgysIeZC+xi2JGt8/NRIUqrExO1q+I+pF6Dz41+o7"
    "8hM+75swwm84l8/EptaYEf7HfVNIPeBfPfhE3eoekXczNlYXxW3Al7esyrom/FNTAoW1z3A+1B9LmME8gKC36HN1"
    "/1g5EJDoyI9bxhweMsa7BTLBc8CQ/Y81mQr72EbPFqhl0S0MGPxMrVwzkPG6/bgeFXQS5u1YIAJIUtIWTPI/ebCt"
    "+1WXtv1Ozbjekp6l7aPqsppW1nDzg5IntD/0/FRyVL+xDd16vhpf+HsPtGd3u6qc73yYn5FSIItvBRqKCuerMhtu"
    "1ZgKR+qkPWu7VrZss/bkhhv2Kl6HjGyy1hzJ+yXqhBtSWKYfw4vpetiWVXsqaZTkc7jW/w12gOuVeav0JqGh92OP"
    "qPtYm6dMOKC690YnpGm8c1OLqb7A+TzLJEZ0TG3CuBfnTJKFdDO6gtqP1t8yH+lN7t3cNbt5XJHcMSFvSqpN7vR/"
    "3nK/Hls8K83CjGjVNc+poxfnafb3HO++0M6o2WYoTc9KaBO/CJrvFe4ZXJWVN1J9IeBD7cZKiONl2kJ2d1d+x9LG"
    "w/ZDoh08DrOXugULwp6V1JvdwnPUZtjWXnzvxi5UR3zThpL1vZyejM7RVScLYzNMnpTqWVZM2tOYLaEPOppb3taU"
    "mMfpxVxyV36npG1gI6zsSHp97+KeL13fWviVa4yOoh8st/UP5SvDFuB72o82USr98mNTQqk7WgUtfnVTXEAmQuLd"
    "e7H7RmdK85LSR4lynb+qSHCMDiN+Rqob6srh1k4dK2KzT2H5GOf9TP+ER2FhpA+dL1t7GjAlW1OCmDXMKQFTCD9h"
    "NsNPQ34rXGYSSdfQVmKiQPYAeu8PXb+0LWhsrrhoHNur6/HvYtV+yn9uXB47pPq2c10GOXFv5FAWl/y5rcFDqqxI"
    "2aOYJBrom9Nj7xZ3lrU4a8cVHZOGDVjQO60HbGuq9rb1xU4uTshtS2qRNLNekjnIz6199Wed1bp3ytvC2+iVnfIO"
    "ZmtFTYs9PXE3Y17vuZ7MbkXLKBc/9Vn4obTRCZLIycEXiJHoUdCecofNpB/KXk28h3oJNnie1Ox1xptWRXODVbjR"
    "3aoOZdOTIlHSJB6TgGRG+TMIbow3ogy6HJQU0A3OiA3oKuih/gR4rHdbz8L2L42PywuLVuRcT/TvPtye1hxYlRSX"
    "GTWWQwjktlqb+iryC28Zq2LxUTOY7rab9e+cXpZc0YCQDwFDKNbOA21H60eVj7dLDY+VX0Mbe+Hd/A5WszRPnxQR"
    "5qR8LxMUrzcG6y7L93HW0+K9WjsMTbMqs6xDuIgQLCMU+aJpXUNVBc6uT8mLyg9A4Q92HWst9nyvZuekKm3+M7GI"
    "HHrattjnwkvBeMoJ3Hm4uaw1vzRpT3gBfjJyHjQOCKyOLr2QdUKzjFfuOxj9BlrdOryusHxr4bJ4DWcb/hBsB/sJ"
    "4yuF5c3DRCKL4Ysgr63Q2GVB8cRN8KuQWjAVGNDD6x7WeKwKYZ2kmyP/IVTiL2kqK5tlO2noj0iSMs4sv5M4v5pz"
    "ZW+tF9PrNXuUqcIXfgL8322iuvzbzDULShZm4bWdko+Mjd5/t5nvgttkiaekT8OvsibRyITd0L/b9LUsaFhXFp7v"
    "Tt0fE8RGEGYh/m5DyDLpuyXXeU6mIKCAcsNrHOTvNlcqBpSYzV/0BOl25mWffMTBf2EzO+Ib2xPwnpSHf4odgZmD"
    "FPwLf9p67b2Enh87VjSJy2+lD1L+EuYfUNi8o8K3sDnrrE4U84PwV5bedzF2a3tc+7jmuvprlrL4aYJRlF6fy9B/"
    "ZZfSY+je2rSjkprvMOhiFoQvCegl/iu7CS2fGsfZtarYsFBmCW0YMYxQivxXdsEt6MYBpY8soL5UPpZ92Pe8107E"
    "v7Kbnm80bY55LTzPy2I/YrQEegX8DPlXdhfdHkdyVl0iJ/IY6yLZ4zUNcepf2i0XlXEZgRTfaqK39zncfexE7GHg"
    "X9nlxAzCF+PC4UORndBF9Kf4MYItmDMoG2iBTQYScW3QVZWTaQ9QPNh+mBMixn2D9RlzSVwUA7IcuR7cDbeBiI5d"
    "RiWqDfYTKABzEcuhefIjrDh4LgjAxoB3oK8BeEdg6wRkNmwd1AJ0QY4AqWls3nJIOSilviRO9VoDJHWM8AxGaKDR"
    "4GygFGwDzOZV4X+9K2ITsH64A7A7iJ8hVZRjGDqNjKAhdgBLoUOAHlQUpENLxv4EXwjphRjBBiQMavNDIfMRBJAB"
    "uw8kQ9cAq1smBV2FqMBBQCqQD/kM3Ih7SqLDrgIPwHxADz0JPO0Std1AZkDFkHQAB5kJ7BQs9JPga5CDvEBEGG4i"
    "gtV7sf0ewgt6ABQA9cj2v/k3NPIY0g/1FOJGzIQgfKqQwymjEAehE4Fn0JdAFBwBDlA+QnFgd8FCSBi4H5YCIVOH"
    "I4OgK4EVkD5gN6QCOJZhx78EzwFuIAw4BW4FugOd6DxIFsAETUAybDiAbJktlUAmAWtADnAROgMQhZnwy5DTwP2Y"
    "sUAfaj9g6z7m2Ym0Q4UgDmhG/v43/xhcFiIIRgBHw9aCBjQGGkBaALNAuIAbkgmwIYmASLAbEQkNAsshpwBvOA+S"
    "T85CPIUMBOZD9gF4SCTwNnIQig1ZBewE1MAh6B1wOu0XVBYYAcRB5gJzYC+B7QwQXdofpwSgGLgGfwfs8XkBq4Ak"
    "ATjYSuBXqALYYaqnz4UPAIcDOECGvv43/9QN9MJUY5HyPLYLesL41u8eyt8+OGIItaD8mvaOoKSVX37UphOtQSVD"
    "vTLe+aVheMU75XJGR/WVDEX01+arrvLc/sI2AQj+/9aOTHSQm1HyXHzIWO9DFadSsZJR9VPtu1NfNO8v22ytliSj"
    "F8Ei0pv9LqMhjsTohGBq48y8WZrozif1ze4RYTvgiRCSHk31Ro9wXI35GBrVPNmBNwKdB+teutZwN2Cb4T36gYF3"
    "vV64TWn+0U/bOiun2f86urP8YPzv4QDnFIwNLtFe9/kIu24t4szz6SpjqSWhQs8KW6BuaHAP9A3wQQPzroWpbcs5"
    "p3wGle1QtYQ8r7+Ssyvu38HuG3kKKYIU6W3Eh3C9gxNZTbtfodJywnPr92WTYi4FP4LsBLyjyzFKqMAayEshj6p6"
    "kxwv/qEF7aLmzGKEQ7cCsdFC7I/QGjtOJPO7VXvXlK2MaWG7DmUvD5wH5YNT5dO9MuChzszYyyHrPMcKlLq/jp5S"
    "t8JqSh0bmAKPgoTENxDnIQHzVs520rfS5oRfuHtbSt2XLPHMC1Av0Ef9GtcBTcti0ddgySV35TD6Uc/Wws70hLCx"
    "sDZwgi6EOBP+zabmPSYWl3MTv3AXNbeWdGZWigtRPZB1qTUUG7LCfoz/kXK6YrRuUMTUliOuozlFLCJ8OPgk7ir2"
    "OQRunB/4BvOkIFhyzX9k7ZSczyom8zg0FdynDsOLYWvN30OOe+8qS4t/wZ7YWlR2NQ9PawFrAWf0TdQYSLepNACC"
    "5TkPyzsZyc1VxYdMOHofZBfwUJmJuQ9BZZXT1V6LneEKH6a5aWPhs/Q/sVdX9Khjw2MYXJgFTFTn+KxDTLNc4Ewg"
    "bXQnqe+wjU3CQlw6MTAUUgoERXeimZDvxmt+J1GBjiCxyfd+bbfJqkgiT+uPaL/IejBU6L6cFGYpfoHraMzPTHfD"
    "S/OlhGv+P0L9wPh4s08tXGINDfuNkOmOUX0NGdo42OqvPeP/EGwAPkRtQz4Fn2X0+MnQQ4s6Re+ouGpKqpdYQEsD"
    "7cAPQiRiNVhrmhPwCuNVtFy4gLqozpQ5Ji6ckgOmAEMFvyNeggOMaUEuLKogSfjSt6zmSvoFOY/CBKOBKoEvogfs"
    "zeTR67Dckm9yv6D9tWsy4uV/Yp9YFZrXnLaY30gQou7lxodPoUUUX1RaOcOrvxjmRM9vX1GNKa7y7YJsAAwxQ3G/"
    "Qi3Zo4O98KOdVxQtwabmccV3TKOI28D1ADs6GyOEdmceDqrGrSmZF61iFHiYBQtSleSPEAoIVaV7/wYLyVGxtN4v"
    "SvKVdcxvTfuK9ZlTCHTQA2RJNiNqwOupQykXEF35k/ly8tua3kxczATKQbAPeCdDojdDzmQlsYZ5G11PFdsZmz13"
    "7HdSXmEbASZgiiiCO8Cs9P0UEnJoYQafRc6u1+V4VNe99wBsoCLyA5wODk1zkpfD5XY891efjpogw2fJn9gvVbJS"
    "QEmLHwm1DEo0+oW4SbYCk0gcEFy+LiFc4Gj94Nph/oA5CUQCHoUKK4HOz1EH53iFltRKPgUUNSyy6JNiccfAn4CR"
    "ijDsXmix9R0f7UusxqdYxPBmi+NmOtknHCwAemNP9u/rOanfqXdRQN5xTghpl+tt/Bj+r8gsgAqwOFqYL+hMNpAa"
    "EInWF5wEwrxyk/ZkRFiAF0QM6KM74DvBnFQnoRPKzMynVcKX56/m3/S5TxgGCIALvMkgF0hT0lEvgR9SErxBqH9m"
    "QkA9cgJzMuQHYIbCG8eGhlgrQ4JxopIjkfdJuRUz1UWsP7E/qU4p3eU4RVmEX4x9635s3JM4tO1aeWLRrK6Tnow6"
    "Xe/azqi2IH8TwgBmpz9g7PaZUobSx0Qd9iwo9DcgOun1nlIlbh3kOvBIU0xeg24uWh95JfBRzYP0ndKENp77u+UL"
    "IRbyBQBFbPQ6GDZlIeMCCax5b2yKed6+t2qng4wQAGTg59DfoLeAjXoj+SfEhSKnsJ1ysFFonaP9d6Lo/03rap1d"
    "6rbnMIpx7xEI+2JZPRfw9Nn7khmdyxuOVNl7QjszWzJYxP54gk+HB6/32l0emlwYsa8p1PwhsaeVV1qYswv+FLgK"
    "2PUutBB6vG5J9ojoXT3X68tcJR3J1gspP2Me9u+IC9JSzFdobu4i5ljc88qhug/SPW3Ymo9FE6DSfuyBnEzYQWBw"
    "2m3fXFRU8QkJyd9VLzOvVv+nsS/vr1/udF6TTwpNJa6qAorN5tjGp1qT4EHL2pLLmdMGyPtr4vfc19gq6MGiROFA"
    "f09jnrFQubpDUdpkDuvRttk8ERgOmAsMVABoAJqR46RF4kZVaLUnBfq2s27fQirSBDkERMQNx81BhOcncJ+T/xjX"
    "I2B3TCoGchMQrH7s4VwRnAfeyngQcBG7qzQobg37SlNqoS39P439f3NbXrEh66hmljgZCYesTon0/YK8bbOJwmgv"
    "y6brgiKqmgmlLeZXIR44BNKre0ymIzn238Uev+9uVvJR0aaGgKKkjH9ndKtyOm4u7LPBK2AEhlyoU1N4/s4Cw3Hl"
    "7MpNeSOTF3JK4eMgE7XLiRRkuh0rraOP86yy+WhXdC5o6C6rCrwFqQK71YeIEJTMjlWGsse0bHQ+ySJ3ouq/u7Q0"
    "Fnw2hKZyU0sx3Q4f7SPxxPa+Sug/8bpPRYdkZ4LfhTyBLAEmJ3zGaaCBFg0r22une2TsguAfG7LMyepov9v9nPi3"
    "2EbMQsiU3LsMAu6BS6xIDxpdeyJjrPTfwX6VUwwLAler43HJ0Cd5SM5x7zGlmTHi4G81+1MhAmFQDZQC1sfUeT2G"
    "xeWvFUTQ8mtLM27LnreOLn2aPTAwE3oHuKaUeTXAyAXjRbdp22odxu/S2c0fi4amz6QdguwHHkb/iLVDxY6Pkjn+"
    "gY0h5mP/xEKHubPSXsf4M473V3Ti2FH4ZvjR3A72XOKIMqLmBFfass7ZmW0MmggOASbJlqOyIFMzhwZNxDa68MqB"
    "jJ0eaQEitdtfDHkPDEnw8b4K0xS0CMiUnyt361ACV4vMGZg1gz0RqgNjNJt9FsMhRV7iatqw6u7URvGBFpvrbPZb"
    "39XgaOC3yC2IVaDOgPSf2p8p9kr2+0+u3ZtdEYcLuA7uAOpkZtR8iC6LHvwOv6Wcp1nDvd4qLtPneYh9QBqgj1gL"
    "v9yfg7b5ZWNJpZEx5pAXzb8VB2XuJ70EsgG1aA7iLTjENIx+yOup+47qCLuquckx6h9rVVPUIp0cvDp4cT9jn63y"
    "9roMxeZamCH4hW58XCiryDPL9qPW7McD5UCjJAGhB5cZtlBzkL85pojeU5fWPjLMkZ4gyEEXUBQ9BT0HEpG7IviU"
    "l8iNil3FXNQ4PK9Twwhoh8wAHHEu7BNIUm5l8G3cjdIxMauCUxoLLF0JXAoOVAPjhGQ4H4xNPURyIb4W4PiJpANV"
    "W/WqiAQ/MqgHksU1/bXYuLSVFCvqdQEu4oBva3199lWVw282qAQSRO/hyeCSlNGUNKTH1hreQrlQrU7fIZ3tK+vP"
    "+6BQCH8FvDLsoS1FooqHR472VdUqDalRf2LvcS7S7YxeFixH3AEPJ4/zPY8OccyTTA1y1g7NmC8ntWdXogsqfKeA"
    "lcAF+SuMDgo1U0MM3nvK3qjCQwObE4umpj/22tHf0ZzINqQYEpQFpbv70a2MGcLMaWosSE1lUkT9MxMirUJlQ1qy"
    "jPQW3NXStzHvmZrmR0WXDVvwBf3cbCVvOrQP2JY8nZgD312QxX9AXFnbaTwo/5nwErAA44W34ftBgZEXcBTb5Bwv"
    "X0pP9xzIb0pOx2QBQcCv7HzoNwCWXEssRQwpqOfvJdvrO7MnxG3AZfRnkAwuDzobeKk75S2AMfMNnAveu2rOpZ/7"
    "B6/bW7ZflcKfGPQQNgNM07+hNKIu2RMFS6hLK9drh4dvaMoqLEybTP0MWgBcnDd2FWRYzk76CuwIV5dcGljVuNYS"
    "rrmNxfbX0L/GfsGWQONtFznNhI8VW5JO8GZ5svPt+hgfEIwHCqTZqE/gVoPHT40+VfhVtI32sO7H7HDVanQJQAOe"
    "ho+FYUFqSjrpELwl/yh3JuFhzR3DCNln/6NACHBYeApyFFga50BBIEEGMhkPj83/Gobx/oWc3I9uGb2zf01GC17C"
    "HgMf429hV0Bzs0/Qa/ADmDdBJhAiH4g4CUgzw3zNcErxuvAy/M+ugXG6oD+xf25KdRfZ3qTSxSXBDys8KQOlDxse"
    "5Fn0J1ouu27m/tKV1WytDQtwwl4AzWl0PxO62FUefZX+U+1jwybprfau6mKH3OsQOAH4GLcVPxDemz8r/Cv5QUVp"
    "YjeP3jK35FXmfi91/5r5KPfFboG+tmwNbfBZVT42fhX7TMtjZ3L2LWRMv/+dfBCOBtsy/H2rkJjiH0TLqMcb7+W1"
    "Jf2nc9zQ6tGZ71WfRVTfL9hNJU2K1JChnsv2ZYbA9pXV1xwf2gfUMEvM1HHQZ8APmhayGxVYQBYs9B1QfjMOFXK9"
    "qcWeq5+D+AhYAaVyFWYa9GteMmcdeXUtNHWrdFKjK7smdgpmJyAGnkUcRY6EuLNwjOlekaWQ2OvByEahJTNBCGX3"
    "Y5/OIvfz+eKkUuIxODQnmOP2OV2em1wt+k9jf9eFbjlYP83AUcqE7S2+ZScLF3furY91b+7St0ypXd0L7d7XcZET"
    "ge6AuPO+h++njq4dZRLFNbZaS+dbZF1djcMqYMQEeCL0mWoayY7WFkCE+2j7K9xJpRHa1hLX5+xWVAjoBA5HfsOs"
    "gwlyN4VEE2Flw1RJHFTziiKvjEfQP/h8OM+GHAPKM9H0G1ina6D8Q+DiBreZFv//2Nd/rk0onJtQJdoYchX6Ctip"
    "nUpaDs+2ekdgKE/LPuiO8WOb2MWzjN/oHyA+4JD4Lz5LYRLze/5DcnTJYc063tsqsfmc5t8Z/YPwOHIxZIF2FaUJ"
    "SctoE+4OgGb6RceE/pK9NdZbUONHhPaB15IyiEMRr20vpChGUpMr/3uSor9+3OyMJAMQKRimfkc6hlyfP04RF0Ju"
    "Dij8NSWg/beKQ7aN+FeQdvBNzDlSIxJXII3LYM9tXeJ8/U8s9GfzZd5LakvAkf4quz0OjgmBLMw5R1dgr5XOjDlA"
    "19Q/zapU0kgfgHhgkew+wgk+Nfr6nUFudFCi3L4XK/fqLfx/B7snYB9YAsyWaBEx4M70N7QbyDFWjmCeL7JALYn2"
    "DaLmQDPBdmWIdxCCa9ULmn1P1I7POCfpa31eyjWtozohs4G46OOYOxCk1cLdRlhYdVX/ll/Y9MrMV50hpYAGoC9S"
    "g0gDYUWLBQ997lYS9DfC/zo6Ld8T1xzR6vsbOAKIUhhwm6Et5ozQk97h5cr4N6GZTc6CAym7KAcAHTAtagZyKwjL"
    "vh20HPNT6XhlJN3aKM+ja1ZSAMhZAKYlELzgYwrdIhO1o2pXMjpiVPNdBzzjF/pIyAtggHY6gQ93FS0TnaAerdqY"
    "LI0wNlc7bIZLhCWAFjgdEQ5XgHbDbL93qH2OZGm6/56aS0aPfIF3AjgWQErmo55ATmRfCzlIKK3S62IEpa3E0oQc"
    "I3Zqv1dj+AsR0RCmyczow7eVv4sPDctu2m93JD/DjgcUAEt4A/EAZOSOCun0HloBaFZz5nqG2Y79I4N8zF3Is/gu"
    "858N2gF6DA4NgzizjwWNxPa5B8d+ZHT2M6jSGB/CRIAC5EYYYPuAr2kwShTiouO1kEWJrvFLdQiP42/0rwpk9HoU"
    "AWIzv2PO8rpTdjbuDZPSGJxHjcf4RoDpwHzZRORS8HnWsKA+DM09V9lKf1632XRG1opz9uf3UexP/W8wQgv10cLW"
    "2NeHTfIGKi5pUjhRRK9+XrSDH4Z8BeEZ8Yyj3vVlI9Tf2XsbZ1vi1d8IlwEusIpHgovBGYaBgRpMhwsWPTRwRHVl"
    "KlvoQxjV3/MK3mnoUgCbLqMNRu4sqY466fuhJioVH/En9m22oNi1EZf8mvr3e6JOSrqLeF24WjSa9rEalnpTtKnF"
    "46zOKiGjwCSgUzELMwcSZB0aWobfUE5WT2F1eui21qQrmBGACDBH3UFGQ7pyRzJnez0tu6BihfR5Htlea0/7zOif"
    "/9YoIgoH8TNzWVe8qsp71XdDcpt223OSt2Mk/XG+lHMbMg6QpzwmesPHFa0XvCcSa9emR0bdw2wAUgFvsRcyH8LL"
    "eRByg3C/4nbiER6v2VW0Mt2CyOjndXvYZJgW5KWN8/VD55a8lUQGPG34IZevvvpfJ0IbQ/44uXLrI4hm+PwiRMRK"
    "MquOZBwm+xM7o4AomcBg+HtDJwONmm34X6DnLK0hv3ltcj9SzmZsariTu0bdRzjWP4elsiJEAOhjgtFKkAdKjou/"
    "UMPrzmeck5Gwa4Eo4HPMELQbUp93JoTkPbd8SkIHt72hOq9eE0Y4DdCBfKkSQQdfpV+hjEbscdwSfqIsrPUYtksm"
    "IdT9Hu7kOKHbAZv+IUEH32WfxNUSRFUrtFPCewjNABVoi5oKOQTg9Wrfu1578vaEAT68MlrcitBn+CWAL/Ao4BbY"
    "CeyQAz5m+C1rZ+hUnyi3XTuWN4QFBYMAXtQn2ChgUJbN34UaVzo48gfKpAq9csw/9vuMuvc5OUlBEZX4gTB7Liuk"
    "0meca4xCyXxY428wy+a1d1dFFD3wbYd0AFf1iwhM+NvCK4JvZEJVkBYVPrblacnozO+Y14ARgGiO4ethOwrGC7iU"
    "G1XR+l8Fg5r9HVMNc3HLAQ4gUZrQ0ZC0vIfM+7hdZetjRweXNUuK2OkJSFk/dr2oCe4Nhphe+sYihxdXi8ooHfX+"
    "Wd3K/3SO41jLRc2BCgofvgDsNvUFt/sEO1XKM6y7lV+SE6MeNK7Iu5vEQM7oN0dEX0JBIcgcVBAc88gJk173662D"
    "Z8TIf4MY+6NBXfQ1VB3EO3dbKM/nTeV+lYdXX2PIgcYPgf/BWs/wP8NQ4O7Ue6Qp8KUFa3hvCTuq96bflUwBA/u1"
    "n+iF0Cv9rHiqtxhWYNrKLMI9Kb+XJOH+p7G/ahnv2plrTO0VHg5Ulot1csnwujVZ9arTzVMdGFNf5+QGdHkD4xNc"
    "Bl4yvg18iXnj2qEYGuyomZuWExXW2u5alS3AwiDbgDexgfgfYQ5bLq+ThKm8kziVB2kJK3qX7of5GYgGFkR7YU5D"
    "/M13GWG486VYZWOQwdNpnZL0Ahrcj/10xAL4TeCxcYpvIuKHYh/RKpJPfXFmqOL/sa//XFtVuiL+LJcT/AUsAqam"
    "tRFvQD1FahGBfLzyJz00fHujxTY2cQitCKwDUAlOr2WQeZYRYRfxPsXP4wjMgKoqo0r274y+juWE3gUM0WicF3RM"
    "wlP6Xq/qxHVhNnJq1DDGaLI3QQCJBi1aE+krosYuVr4NprT97qDqpF3dDdElr3B8cApwQLmKUArPM/dGDvQraTye"
    "xYje0Toif27iEoQQHAbMF3fjgqDPzHfEBCqlxZIn+qczqxn2lbwEkokqBgWALOEg+ji4Pm8Q6zH2fHlf/EXml8Zu"
    "80j5PPyE/pX5UPoMthmoMV6iBiHaSjdJvMhnS44nCtj/DvYK4vj+nidyN0NcwJEkDvULNFI5hHaMsqoKSFgVvoG4"
    "tH83zZblYgOhrjwE7z5xVsWANJgA6ADcgO4qAQtGAXf5t2BHgNm5A4L2Yq5UPtVe8dtay069Jn/pvQsIAM6ErYdU"
    "Az2WITwDoc7OTk0l/nX0LSUnVIN5OwK2gBnA2cRLXgholQ3F9sc/K0tQvQx+1gA3N6os5J8APmCLHYpqBHebP9Nn"
    "owWlkOiD/oPqGozNUgYhFHQAcu1GvBrqWziRX0RYVOGV9J1zvfFB3seEBooYdAPoJBr+K6SnYBRvl/eKclS8gBXZ"
    "MD7nY8x1r9H9+VEtwSGiQESGwm8q8q29U7iJ/L38vDYiPAzDACcCB+MGee2Bpdr2Cb5TO+q+p9eI37csKVmeIUX2"
    "M1rgpgSCmQoJzk1kLfEa776hlNHP1a03vpbWo8YCQsAiHY26A4bl7Q5heP1SFhD7nX6t1mBojfwTu7HorHiG30++"
    "VaASmKkagb4LpufcCNqAflfWLP89oN5tMT0Ws7CW/reTJ4LDpgHrM4aQFsO4JWj+akJz9W+6upBdXmsBNpCpgqGv"
    "gi7Lema6V3vZmtgs1t6acYYxkb7Ez4AMgCv7kJVgTs6SQDh6tWtWdJ/f3fpL6XihHhHe37MvhwVJAt4knvY6BzHb"
    "F4ddxr0vFcca6fneH8BZALYfXSY0KreVe4+oqJ6fguAk16zNKIxZQuaBLGB1xFXYaaDQqPGjIHyLOfxDBFdFlLSI"
    "Op10sD/7LxB2QpsAtSGUooddLfnKL8JecmUreIF/Yo8r+aIi8eNZZdDxQHzyUSIbvtaxRjic4qxeq//MtzW3FPJS"
    "JxD3A6HAvth56POgjxVk3cbKy24qQ+lFDXuzF8YQMcP7+dXy2C3o1yDWagqZh1OUH4obGfyhIT1XoCrz2Q6EA+Nj"
    "RRgiJM/6JkTtdbQsKW5Y8O6Gm7kDVQzUH/n9In8BdB5ASU8iB8HFhVB+NSG3iqa7y9uHvA/kAN2xK3AGWKY1VFDi"
    "+0M/31sZ6WkhFp8zFMOyAX+AIxyNWNufnecFBGHaXSOl7X6v6wIyM+WLYRH9PQ8RzIO9ARTG333tyE/OeeId1NW1"
    "79Ib//Hey0viFXeYD31fgImAV8IHjAZyNvc5MwlHdguifw701PxuuCxtxZb19zNCMhN+GAjJbKLVIY4WXxfuI52v"
    "vKp5xnZhngJiYKo6HAODVFkxoQC+pPJMwteQ93XZed1xJ3Dj+p9Ni7LA3wCeDA21GlnmCI54Q84t06hOsm5AmP3a"
    "HM4i6DSgW1/qcx86NE/DGo9bUvp79NGAdvITMA/Yp1IhFkAweZdCDv/XbjWzfQv/+Jut3aTvkJkAQ3cSp4UBuf17"
    "2Oda6x/frY1z3Vd4Ant8+JB64IRwI5YAGeoOEVxA7ag4q/uV9UccMVP+EesqglOOR60O+9xfSTWkP6RMROwtXhTZ"
    "TjtT/SjlvnBby9KS+aYy6gowFqAm+nlBob/lo8LyvD+VJ6odrC7PUeu0xDTMkf41/1si0SsamlgwPfww4VXlzMSa"
    "sC2eC7YxSeN8tgBMwEu1DH0d5Fr9WFjcs7L3MUIG1+NtFSfOhv+x5ltFIPw2MDtjLQVAZBb5898RfGomprwV/qdz"
    "XEzuvIh42o/ev/bX0UtTzhDXwl7ZhnH4eJ6bFXOdvqBmgWGsdDaiut9DhZSN+AaIjVTfPoTRsYaX5bO26k3SQ64I"
    "9gcnj4uJR20EWSYyY6PX9XKDrI5hqiGnX1H2wf74prUm/BF0ItCZfImwEfYkP4aT4CN3r4jbyrwD+AA4gMWcDykD"
    "VmpueT2GMK0W5mfMi9IBihMB/2nsl+oXmvckFseMoE7DhFrfcnoI2op9msm8tw3J5ky1tM1QXmv1CXgJqQK+aKcQ"
    "foHl2Xn9+UJdcVudGoppirAv1/ei9vfH6jj1BNxY6Or812FxBEf5KjUu9IzHZlunVXpN7485MvlyZD1ozV7pz0Rd"
    "cL6RPPDd2bAo5wfVJtgfvM4iHAZbAXQYAsinYX2Fb3hfvXk191Iswv/Hvv6DtUwKUTSJiTLVS0ghHwtlurOSh+X7"
    "crYkddayChEmdmO165SluAPb9Knm52RCVGDYNI2RrfZ1Zz6XrGVxCx4n3hCXlk40dqseV8rz2pOftgys2eSakTlA"
    "aRRw07xFjuDVZn5sc7jBMSW5RD6s7FvWQE1YtcWWkMZpDqx8XbRQM4KT7cdKzxZ9Y9zOD9UcFe0rfWz8pMJVT7XG"
    "pX6pMzrWZslbd9SccqE4jd5c5GrJOt9fsce0yZwwakOOST4vJL1wRdJDcVzp8YyPsR3104u5OROjhtMC8XL5Vv+v"
    "+AuJqtBL5LGZfVHWYCC/U13PJ5TEpgyX9VXprdNTdiQPFi4KPpPFlu9k73UcSR4rD6yEW/T6YXVXi8RZvzVeLD1k"
    "VXSs8aTULEreEDmP45s0lrPKd0emVfqNNbcgOOmq+MfSQ8YK1YnK3y1hyZ+b91elleQlruVfCTYrmoKmEQbreNwn"
    "tJIcZLQfu6QQo70c6V16ImNw3LDGoaUQ25ykBP6QwNbM09JK9rPCDF239H5ZSvZ3zeGaTXZYxi/1r0q+53q1ldbF"
    "lDVEXaZ2Y78po4NGesekiMOT/ZxmrjKf4+dg6s2SsW54Zqea2rCjZGtucxTHv7+al0L8D+DbEvayXpHCjWXikfSJ"
    "VrkqOvyw47oeLl1V/cJ2LG23ZXrCyag9tirNkqhF7rysxsS5NfQCsfFLwztnj4XSHFvRW3in83oLppGY+zTeV/LA"
    "xJTLwg5YlKpLAkVxWupWhbRcmCNJ2lSdmr8i/Xxrdp2u7FH6Rfle/jQpz1/ovU6DCx1NGWFiRU0Kvm3bo24S7Cpu"
    "TumVX6wfVyIyjzZfUPOFCfmDtahof/fGzDNJYbVxhS9M5xoRpVvyQpvvlZntHR3BTZtq4Gk8GZ4jziqQrWOrLYfj"
    "SvhnirekuBQC92cTTFNWfbNgV0Zuc0slzfE46ldfPh4rD/f/GV+Y+JHdR1lkXBwpCI6ztMVKeb/ba7UrI8NrdtlP"
    "GR+0bmgcWr25ubD293JMndL5uy3Bk+QmFCz3+FVMsV9quV4V5lrRU90l7kA5/Q0HYtvrJ5RcMs9tjq0OcL1u/Vr3"
    "sXx9W3GDsepwe5XHXS3qbmp/0DxDsTt4FZGc2Bi21e9JKk/IZ5zNPacczzMW7E9aHnXXudxwJvaiB1l+vEBY+ca+"
    "0vyhtdBjqE9r5lZsc/7Q+quz2cZpPltkNpMbfAuZ5v1de1qDmvD5s+JCxQuLetOCVMdqzhZ0Zt2qn+I8YjnY6qoa"
    "XnyxnePRVcV3Lmm+Vn8+KTriWcDmxITweFpRBkI2m3k7TxMzntdclK8liqhFG/UXJJ9rCvKrDf+bY12tbrEghzHL"
    "sFf8iEEqZGkLosrLn2RrEkW1OwtoxtrG6a4ey9H2W43U6vZkmWQ7N189j9lEnpNhELcxVHYfzQFhQ2m5EaayVs3N"
    "G5rc2rytcpAj01SpnCYYngRwjf5XM3dKt4UgC88ltUaOLdUbd8WBlQ7zda2ocZIrMi8iicurDrAkb+ffDZRY41V7"
    "+TUurAEeU1lZbF6prahVFdw2mJo3VOwoHBjq530YeUX4nLQGvSx+WXALIdUkiHTT1faZ8RrBBOe5tPnRKTXj8knp"
    "8yLKKAexB4XvyVsw7pimwEv466nV4YtoCPP+aN9QZOERjUN4psyTtSN+kCaBNz0QkfE08jCzruilziitr9ie26mV"
    "11GKDplWNAaVzs+b0q5rVFTlJi4RNLGS1WbmJNLWDKOYyhidT0mYFZHiKjfsjNlWQTKv0xY3LSs/W1CfSBalsEdL"
    "u/x/9M5LOsY+TfVkn5ctD4EXipM84vGuU4YLMRX1w4ozc07qGBGpwZHph8QEFt++SNMkvuDebXqrDq6h5dek1dZz"
    "iiOyPS246vSSsLBAAgb9TvyeQsc+1hSGYMl9WVXS3cyigoOaBmGf802aXoGoWZB/OH2yMJn2FY8Vkila7JgYdNB4"
    "74Q0KT/Zj2kmKHaGrirISYwS4Ss0ufuSSOlvo0azd2VFKfx5hJKTaZNjJlWVWIen7qg/W3ww57pnWlmEfX/HiqY9"
    "tSatlzAgZKluJm+B/9wcP8V9jqPog84iXeuuyFwQ31v1a15aSnZzWaXW8UhsD3pE3hAxmHwaE66uDrYQ+zI+i6x0"
    "qm2N6nl4a/H35BkyT92dot6s9lSH5DzHk5sUR44glhZkXI2LqH5u/SV1e31fyencCk9AWXb+0nZF47HKPvnBAB/v"
    "bar3jMFEcfq+CEYQP48T+5GrduQl58pWuk8aJ6hM9dJiSs4MXgbpEfonEYuixBpUuxhI4qn0KGFI0EXzeaUt7FjB"
    "9cSF4k2VLy2O5K2VRvPkxPfFIUYvTb17aea8hJVVldaRKYvrNxd75YxqWlWeYL/Vtbytuemm1azyEghcV4074w0V"
    "i83fkqk1xIJ3Rm79luKJuT80His9bnN1QJp+rdkpn0cfTPKJfcrII43VX+dZ/BXZBXIYu8m+TnNe1FuSnHZTcaXB"
    "7lqRt9KhN5zSnLTAE/3kdQX0xAEikzsyY0+crNYnf25qfUOKa2RuRUevx1NdmTE73EM7aMvVnBDby8m5v+n2VXfZ"
    "fzNeq7vmCMw53XirdKjlZaPGnWHD8X2JZ9FkKZ82EueX0MY8TWxLTeK/8n+cDYl+GFpq3xDPFSIq5Ll3k/43x7r3"
    "CZE8e6CX1skN9fPkL1CvFijKvDLfqWS1YjslvaBxQElpTlQbpY7qXqI9KG5jNymGBN7wWZRay8cH7LJCVJTwzc79"
    "ae7o1+XlOT2a7IbpJbhchW5zRF/wQ8X3wDYfVso3Hs7vRzNbOZj9rnBg4g7hBOfHtAnR16oW5hUl4+PSg9GkF5qh"
    "oacpl7KTZPtZix2h+u6oBWXvMvPjC2tn5U9Oe9aY7S62VvB/JqEwmwTviGdRWXGooJ346eldApN/jfVF7B5ud5FV"
    "Z5Lsr+TnPIg/wVyN5cDPs0DcTNiYSBY5FM3Svgou8bma9VJCZZCsGdEaxocSVvJ88cqEKVxLQFfKz4LIIGhBZKKf"
    "GF5OzH6XYK4NKnhvIDVudEabsW28uha3V+INwVtWoOJ7wDFvbEpo+CK/HMsLZULYdMcpPVq6zD3bBFUH1h9yILJr"
    "4gfx3cE60WtKIG6FOjH4FeFAhl2EC1piFcXVc2WOJTp41NxKnaVPNz+5MGIafY9ewI8OVNlS1Mf5O0phGUdifqn6"
    "ZJHrcLXygvAMZRO83Jmv5iWTXJjXQhplCBaihjFcPhrDfYEr4Jh1fNyNsJaiubqZ4jeVU3NqtO94neTn2MNsDh6L"
    "yI6SUPrQyCRViIcYljU/cirdnr9UMSok2umbppDNSt4vfMTcaPwmPcL2Lj6fQldcrPxiGZncXH/Wwc8e5Vnk3mBT"
    "t09qoFWuS/iJN49eHh/GiieTjS7xDfoVW2C8VfC5xJLGUiSVL8peopndUOtcbb7BuUt+7iXmzfP5HQmLXR7o7f05"
    "jSqo8++yHFGWcQqK1NpLYr8qeN5X/e9pK6Ly2dsMgqgDrDYHUi+T4iuCzSLdltqOQn/TtkZv1xLLixZKDc7l5r71"
    "HoEyCWeRdJjgxPNMPemp6UAkMphmrVcLBWMcw1LyZO6K4lyZdjA7wPs3REs4lnAHSVJQ/L/hBmi3sLmUFiNKrAiK"
    "svykGB+aVDww+aF0XYFan6KA22Yl8qS+JYtSOxRBlW392cq7LqCovxpvDHRdMas7Gj3bqh9kJSnSw9w5rUoRT253"
    "Jj4Tj3W+SUfGLi8/nvM46UV1Sr5vuqPZU+ly8CImURS4pRIh7QjuUsI+1kXS0wyqWE/3sRriYngbihS63KicGrV9"
    "v+GkyRSXGxmfnhqVzB5lO6M6yJ/gUhhyFTNqH1lHJ3+oo5YkmY41w6oOFS+OLA6c5NOjXcS55ZecgYlayjxm+13t"
    "FvjYaQmPhUp3c8aQ6HuVuyxlup8DWlFV0IthGfgfEAHyo7TZuF2a+SHTSN8yZot6grbkfpKvC/1WfC35gOx/c6xr"
    "UTCYJeRw9VemjlRq/aTsYu9xp2UsVRyvnWcbp0c1BhR/NlFahBX37EjV3dAzvlDRbdIcdLGmKbjXpyt7SCSSvsV+"
    "Pn4H74eSz/rXkbPKlpluxZr4q0kT0GO4P+DvwX+STfXtwNTqZSFin0U5F4W2QC9zuXIwU17g0bWJTIIzRAPaoyQG"
    "TMMbsvKiaIyrJRU6nHBHJSb3VcLNmoEFweqFjSPdPVkQthiTBdsYrMAugZ6XoqgDUHWG8VHXaYez50urWW3F3obh"
    "glVVZvOtKD/KEVQidBs9EhUHvcG+4LMb3pc8LUSEPpC6hWUnlOnLOBLSH+f/Zso8BYmBJ5mSJrOHUX3tc9S7wy+4"
    "habJcUNrWm2jU5rrI4oHZ53sr7WjigJVPWysf654FTkOkxR/nLHJR2KcJNwSgLSGx9zkbCwK1LaIW8onZA9KwIsb"
    "abO8nrExeB7ikWQQ5RZ6XtL6EF/iQNNA0eKAJ3lLlSHsdcX79EKJOPY9Q0yMT/wW+ozyyiyXe4ecLclKMcm9K6qy"
    "8OreOlr+G52k6b7ze3Yup8PnPTIu7APeG3kjWuDXjDMafEWnA3JyU2JF3LmONAUQ3OCcntWu+4G+FW9GbAlwoyoh"
    "04V5voW4jfrrwQifHTmXQg4ROIUW/XLOZAct/agoTJUeEk09lOIUTAmcUVSm64siVE7IfZ40s85aFJLZ5IG46/Ii"
    "26LrBrvPKH4OzqEuk670zcat0EVyzlD8cz/JhCFrCn9PnCKqduUaflKSai7np6dPDNtP+I7OZNd6bYb3yFp9ldh8"
    "3Vb2XnJRVn1UJiPcNjDuPRcsXWFYESNNFIaNpHHSq4UDg2QOS1KgOLvslgmW4FudkUdL/lILcSw2TfBgSrNsqcxh"
    "eBRiFq+M6ECPi09gBBBGZqRGPPKjWnTRHwNl1sqET5xF9iv6ibxW+iLUEQiDgcEKYcXcaz4dyEmydQHNuJ+TYRwJ"
    "MdIUIXzoW2aaJZ7l15s5Xz4yTGL0lkBCuovitcPFj8oDskviA2uz7O3ppMY7JYuzDW3IOmepJqGaMZKwJpHEvk1J"
    "MzaIefQU2ygVN1xc0pxCkY1wwzKHq5rrPEWhmSI2zTsIeTjiK/EM6nYsLOgJnpL6nZdDe5zDky9jqezhCQZBZ/mu"
    "7G0aV+rcSD37oep+SIkv1LxQZgsOcbWmrIxiVXnnHIuTV0hyf0kkN8pcHdZlEeepFNxrQYRPBYKrWEkLQP+mG8zh"
    "UjcZ70s29e+7vPjnnLduccr1yJ9J6xESaBfjIeYCtIC/zisPNkqxgjoc8yp+VvAAr3fJeI6CuMa0KMr1v/q8rrVz"
    "c9v99ADFEmoq4SqILaQZD8WNxmGq+CUhmiMKB4lPeAKoU44p7oXNpN/H9CBXgB3k7T4nvTneTWAHYPun/4GUCuuJ"
    "D677P/PILDM=")

_CDF_LAYOUT = (
    ('kf_y_mode', (5, 5)),
    ('angle_delta', (8,)),
    ('uv_mode', (2, 13)),
    ('partition', (20,)),
    ('tx_set1', (2, 13)),
    ('tx_set2', (3, 13)),
    ('cfl_alpha', (6,)),
    ('tx_size', (4, 3)),
    ('filter_intra', (22,)),
    ('delta_lf_multi', (4,)),
    ('dc_sign', (4, 2, 3)),
    ('eob_extra', (4, 5, 2, 9)),
    ('txb_skip', (4, 5, 13)),
    ('eob_pt_16', (4, 2, 2)),
    ('eob_pt_32', (4, 2, 2)),
    ('eob_pt_64', (4, 2, 2)),
    ('eob_pt_128', (4, 2, 2)),
    ('eob_pt_256', (4, 2, 2)),
    ('eob_pt_512', (4, 2, 2)),
    ('eob_pt_1024', (4, 2, 2)),
    ('coeff_base_eob', (4, 5, 2, 4)),
    ('coeff_base', (4, 5, 2, 42)),
    ('coeff_br', (4, 5, 2, 21)),
    ('cfl_sign', (1,)),
    ('filter_intra_mode', (1,)),
    ('segment_id', (3,)),
    ('delta_q', (1,)),
    ('delta_lf', (1,)),
    ('skip', (3,)),)

DC_Q = (
    4, 8, 8, 9, 10, 11, 12, 12, 13, 14, 15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 26,
    27, 28, 29, 30, 31, 32, 32, 33, 34, 35, 36, 37, 38, 38, 39, 40, 41, 42, 43, 43, 44, 45, 46,
    47, 48, 48, 49, 50, 51, 52, 53, 53, 54, 55, 56, 57, 57, 58, 59, 60, 61, 62, 62, 63, 64, 65,
    66, 66, 67, 68, 69, 70, 70, 71, 72, 73, 74, 74, 75, 76, 77, 78, 78, 79, 80, 81, 81, 82, 83,
    84, 85, 85, 87, 88, 90, 92, 93, 95, 96, 98, 99, 101, 102, 104, 105, 107, 108, 110, 111, 113,
    114, 116, 117, 118, 120, 121, 123, 125, 127, 129, 131, 134, 136, 138, 140, 142, 144, 146,
    148, 150, 152, 154, 156, 158, 161, 164, 166, 169, 172, 174, 177, 180, 182, 185, 187, 190,
    192, 195, 199, 202, 205, 208, 211, 214, 217, 220, 223, 226, 230, 233, 237, 240, 243, 247,
    250, 253, 257, 261, 265, 269, 272, 276, 280, 284, 288, 292, 296, 300, 304, 309, 313, 317,
    322, 326, 330, 335, 340, 344, 349, 354, 359, 364, 369, 374, 379, 384, 389, 395, 400, 406,
    411, 417, 423, 429, 435, 441, 447, 454, 461, 467, 475, 482, 489, 497, 505, 513, 522, 530,
    539, 549, 559, 569, 579, 590, 602, 614, 626, 640, 654, 668, 684, 700, 717, 736, 755, 775,
    796, 819, 843, 869, 896, 925, 955, 988, 1022, 1058, 1098, 1139, 1184, 1232, 1282, 1336)

AC_Q = (
    4, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
    31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53,
    54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76,
    77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93, 94, 95, 96, 97, 98, 99,
    100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118, 120, 122, 124, 126, 128, 130, 132,
    134, 136, 138, 140, 142, 144, 146, 148, 150, 152, 155, 158, 161, 164, 167, 170, 173, 176,
    179, 182, 185, 188, 191, 194, 197, 200, 203, 207, 211, 215, 219, 223, 227, 231, 235, 239,
    243, 247, 251, 255, 260, 265, 270, 275, 280, 285, 290, 295, 300, 305, 311, 317, 323, 329,
    335, 341, 347, 353, 359, 366, 373, 380, 387, 394, 401, 408, 416, 424, 432, 440, 448, 456,
    465, 474, 483, 492, 501, 510, 520, 530, 540, 550, 560, 571, 582, 593, 604, 615, 627, 639,
    651, 663, 676, 689, 702, 715, 729, 743, 757, 771, 786, 801, 816, 832, 848, 864, 881, 898,
    915, 933, 951, 969, 988, 1007, 1026, 1046, 1066, 1087, 1108, 1129, 1151, 1173, 1196, 1219,
    1243, 1267, 1292, 1317, 1343, 1369, 1396, 1423, 1451, 1479, 1508, 1537, 1567, 1597, 1628,
    1660, 1692, 1725, 1759, 1793, 1828)

SM_WEIGHTS = (
    255, 149, 85, 64, 255, 197, 146, 105, 73, 50, 37, 32, 255, 225, 196, 170, 145, 123, 102, 84,
    68, 54, 43, 33, 26, 20, 17, 16, 255, 240, 225, 210, 196, 182, 169, 157, 145, 133, 122, 111,
    101, 92, 83, 74, 66, 59, 52, 45, 39, 34, 29, 25, 21, 17, 14, 12, 10, 9, 8, 8, 255, 248, 240,
    233, 225, 218, 210, 203, 196, 189, 182, 176, 169, 163, 156, 150, 144, 138, 133, 127, 121,
    116, 111, 106, 101, 96, 91, 86, 82, 77, 73, 69, 65, 61, 57, 54, 50, 47, 44, 41, 38, 35, 32,
    29, 27, 25, 22, 20, 18, 16, 15, 13, 12, 10, 9, 8, 7, 6, 6, 5, 5, 4, 4, 4)

DR_INTRA_DERIVATIVE = (
    0, 0, 0, 1023, 0, 0, 547, 0, 0, 372, 0, 0, 0, 0, 273, 0, 0, 215, 0, 0, 178, 0, 0, 151, 0, 0,
    132, 0, 0, 116, 0, 0, 102, 0, 0, 0, 90, 0, 0, 80, 0, 0, 71, 0, 0, 64, 0, 0, 57, 0, 0, 51, 0,
    0, 45, 0, 0, 0, 40, 0, 0, 35, 0, 0, 31, 0, 0, 27, 0, 0, 23, 0, 0, 19, 0, 0, 15, 0, 0, 0, 0,
    11, 0, 0, 7, 0, 0, 3, 0, 0)

FILTER_INTRA_TAPS = (
    -6, 10, 0, 0, 0, 12, 0, -5, 2, 10, 0, 0, 9, 0, -3, 1, 1, 10, 0, 7, 0, -3, 1, 1, 2, 10, 5, 0,
    -4, 6, 0, 0, 0, 2, 12, -3, 2, 6, 0, 0, 2, 9, -3, 2, 2, 6, 0, 2, 7, -3, 1, 2, 2, 6, 3, 5,
    -10, 16, 0, 0, 0, 10, 0, -6, 0, 16, 0, 0, 6, 0, -4, 0, 0, 16, 0, 4, 0, -2, 0, 0, 0, 16, 2,
    0, -10, 16, 0, 0, 0, 0, 10, -6, 0, 16, 0, 0, 0, 6, -4, 0, 0, 16, 0, 0, 4, -2, 0, 0, 0, 16,
    0, 2, -8, 8, 0, 0, 0, 16, 0, -8, 0, 8, 0, 0, 16, 0, -8, 0, 0, 8, 0, 16, 0, -8, 0, 0, 0, 8,
    16, 0, -4, 4, 0, 0, 0, 0, 16, -4, 0, 4, 0, 0, 0, 16, -4, 0, 0, 4, 0, 0, 16, -4, 0, 0, 0, 4,
    0, 16, -2, 8, 0, 0, 0, 10, 0, -1, 3, 8, 0, 0, 6, 0, -1, 2, 3, 8, 0, 4, 0, 0, 1, 2, 3, 8, 2,
    0, -1, 4, 0, 0, 0, 3, 10, -1, 3, 4, 0, 0, 4, 6, -1, 2, 3, 4, 0, 4, 4, -1, 2, 2, 3, 4, 3, 3,
    -12, 14, 0, 0, 0, 14, 0, -10, 0, 14, 0, 0, 12, 0, -9, 0, 0, 14, 0, 11, 0, -8, 0, 0, 0, 14,
    10, 0, -10, 12, 0, 0, 0, 0, 14, -9, 1, 12, 0, 0, 0, 12, -8, 0, 0, 12, 0, 1, 11, -7, 0, 0, 1,
    12, 1, 9)


def _nsym(name: str, idx: tuple) -> int:
    if name == "uv_mode":
        return 13 + idx[0]  # without CFL, with CFL
    if name == "partition":  # 8x8, then 16x16 to 64x64, then 128x128, 4 contexts each
        return 4 if idx[0] < 4 else 8 if idx[0] >= 16 else 10
    if name == "tx_size":
        return 2 if idx[0] == 0 else 3
    return {"kf_y_mode": 13, "angle_delta": 7, "tx_set1": 7, "tx_set2": 5, "cfl_alpha": 16,
            "filter_intra": 2, "delta_lf_multi": 4, "dc_sign": 2, "eob_extra": 2, "txb_skip": 2,
            "eob_pt_16": 5, "eob_pt_32": 6, "eob_pt_64": 7, "eob_pt_128": 8, "eob_pt_256": 9,
            "eob_pt_512": 10, "eob_pt_1024": 11, "coeff_base_eob": 3, "coeff_base": 4,
            "coeff_br": 4, "cfl_sign": 8, "filter_intra_mode": 5, "segment_id": 8,
            "delta_q": 4, "delta_lf": 4, "skip": 2}[name]


def _unpack() -> dict:
    flat = np.frombuffer(zlib.decompress(base64.b64decode("".join(_CDF_BLOB))), "<u2")
    out, at = {}, 0
    for name, shape in _CDF_LAYOUT:
        rows = []
        for idx in np.ndindex(*shape):
            n = _nsym(name, idx) - 1
            rows.append(tuple(int(v) for v in flat[at:at + n]))
            at += n
        out[name] = (shape, rows)
    assert at == len(flat)
    return out


_DEFAULTS = _unpack()
_COEF = ("dc_sign", "eob_extra", "txb_skip", "eob_pt_16", "eob_pt_32", "eob_pt_64", "eob_pt_128",
         "eob_pt_256", "eob_pt_512", "eob_pt_1024", "coeff_base_eob", "coeff_base", "coeff_br")


def _nest(rows: list, shape: tuple):
    if len(shape) == 1:
        return [list(r) + [0, 0] for r in rows]
    step = len(rows) // shape[0]
    return [_nest(rows[i * step:(i + 1) * step], shape[1:]) for i in range(shape[0])]


def default_cdfs(qctx: int) -> dict:
    """Fresh, adaptable copies of every default CDF an intra frame reads, the
    coefficient ones of quantiser context `qctx` (0-3)."""
    out = {}
    for name, (shape, rows) in _DEFAULTS.items():
        if name in _COEF:
            step = len(rows) // 4
            rows, shape = rows[qctx * step:(qctx + 1) * step], shape[1:]
        out[name] = _nest(rows, shape)
    out["eob_pt_512"] = [p[0] for p in out["eob_pt_512"]]  # one context: 2D transforms only
    out["eob_pt_1024"] = [p[0] for p in out["eob_pt_1024"]]
    for name in ("cfl_sign", "filter_intra_mode", "delta_q", "delta_lf"):
        out[name] = out[name][0]
    return out


# Block sizes (BLOCK_4X4 ... BLOCK_64X16) as (width, height) in samples
BLOCK_SIZES = ((4, 4), (4, 8), (8, 4), (8, 8), (8, 16), (16, 8), (16, 16), (16, 32), (32, 16),
               (32, 32), (32, 64), (64, 32), (64, 64), (64, 128), (128, 64), (128, 128),
               (4, 16), (16, 4), (8, 32), (32, 8), (16, 64), (64, 16))
BLOCK_INDEX = {wh: i for i, wh in enumerate(BLOCK_SIZES)}
BLOCK_4X4, BLOCK_8X8, BLOCK_64X64, BLOCK_128X128 = 0, 3, 12, 15
# Transform sizes (TX_4X4 ... TX_64X16) as (width, height)
TX_SIZES = ((4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4), (8, 16), (16, 8),
            (16, 32), (32, 16), (32, 64), (64, 32), (4, 16), (16, 4), (8, 32), (32, 8),
            (16, 64), (64, 16))
TX_INDEX = {wh: i for i, wh in enumerate(TX_SIZES)}
TX_4X4, TX_16X16, TX_32X32, TX_16X32, TX_32X16 = 0, 2, 3, 9, 10
SPLIT_TX_SIZE = (0, 0, 1, 2, 3, 0, 0, 1, 1, 2, 2, 3, 3, 5, 6, 7, 8, 9, 10)
TX_ROW_SHIFT = (0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2)


def tx_sqr(tx: int) -> int:
    w, h = TX_SIZES[tx]
    return TX_INDEX[(min(w, h), min(w, h))]


def tx_sqr_up(tx: int) -> int:
    w, h = TX_SIZES[tx]
    return TX_INDEX[(max(w, h), max(w, h))]


def max_tx_rect(bsize: int) -> int:
    w, h = BLOCK_SIZES[bsize]
    return TX_INDEX[(min(w, 64), min(h, 64))]


# Partition types
(PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT, PARTITION_HORZ_A,
 PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_VERT_B, PARTITION_HORZ_4, PARTITION_VERT_4) = range(10)


def partition_subsize(partition: int, bsize: int) -> int:
    w, h = BLOCK_SIZES[bsize]
    sub = {PARTITION_NONE: (w, h), PARTITION_HORZ: (w, h // 2), PARTITION_VERT: (w // 2, h),
           PARTITION_SPLIT: (w // 2, h // 2), PARTITION_HORZ_A: (w, h // 2),
           PARTITION_HORZ_B: (w, h // 2), PARTITION_VERT_A: (w // 2, h),
           PARTITION_VERT_B: (w // 2, h), PARTITION_HORZ_4: (w, h // 4),
           PARTITION_VERT_4: (w // 4, h)}[partition]
    return BLOCK_INDEX[sub]


# Intra modes
(DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED, D67_PRED,
 SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, UV_CFL_PRED) = range(14)
MODE_TO_ANGLE = (0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0)
INTRA_MODE_CONTEXT = (0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0)
FILTER_INTRA_MODE_TO_DIR = (DC_PRED, V_PRED, H_PRED, D157_PRED, DC_PRED)

# Transform types
(DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST, FLIPADST_FLIPADST,
 ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST,
 H_FLIPADST) = range(16)
TX_SET_DCTONLY, TX_SET_INTRA_1, TX_SET_INTRA_2 = 0, 1, 2
TX_TYPE_INTRA_INV_SET1 = (IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT, DCT_ADST)
TX_TYPE_INTRA_INV_SET2 = (IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST)
TX_TYPES_IN_SET = {TX_SET_DCTONLY: {DCT_DCT}, TX_SET_INTRA_1: set(TX_TYPE_INTRA_INV_SET1),
                   TX_SET_INTRA_2: set(TX_TYPE_INTRA_INV_SET2)}
MODE_TO_TXFM = (DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST, DCT_ADST,
                ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST, ADST_ADST, DCT_DCT)
# 1D kinds of a 2D type, (vertical, horizontal): 0 DCT, 1 ADST, 2 FLIPADST, 3 identity
TX_1D = ((0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (0, 2), (2, 2), (1, 2), (2, 1), (3, 3),
         (0, 3), (3, 0), (1, 3), (3, 1), (2, 3), (3, 2))
TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT = 0, 1, 2


def tx_class(tx_type: int) -> int:
    if tx_type in (V_DCT, V_ADST, V_FLIPADST):
        return TX_CLASS_VERT
    if tx_type in (H_DCT, H_ADST, H_FLIPADST):
        return TX_CLASS_HORIZ
    return TX_CLASS_2D


def _default_scan(w: int, h: int) -> tuple:
    """Default_Scan_WxH: the anti-diagonals in turn; square sizes alternate
    their direction (a zig-zag), wide ones run each from the left column,
    tall ones each from the top row."""
    out = []
    for d in range(w + h - 1):
        cells = [(r, d - r) for r in range(h) if 0 <= d - r < w]
        if (w == h and d % 2 == 0) or w > h:
            cells.reverse()
        out += [r * w + c for r, c in cells]
    return tuple(out)


@functools.lru_cache(maxsize=None)
def scan(tx: int, cls: int) -> tuple:
    """The scan of a transform size (64-point sizes read as their 32-point
    top-left) and class: rows first for the vertical class, columns first
    for the horizontal one, else the default."""
    w, h = TX_SIZES[tx]
    w, h = min(w, 32), min(h, 32)
    if cls == TX_CLASS_VERT:
        return tuple(range(w * h))
    if cls == TX_CLASS_HORIZ:
        return tuple(r * w + c for c in range(w) for r in range(h))
    return _default_scan(w, h)


@functools.lru_cache(maxsize=None)
def coeff_base_ctx_offset(tx: int) -> tuple:
    """Coeff_Base_Ctx_Offset of a transform size over its coded (32-point
    capped) area, row-major; the shape rule follows the size itself, so
    64x32 and 32x64 keep their rectangles' offsets on a 32x32 area."""
    tw, th = TX_SIZES[tx]
    w, h = min(tw, 32), min(th, 32)
    out = []
    for r in range(h):
        for c in range(w):
            if r == 0 and c == 0:
                out.append(0)
            elif th > tw and r < 2:
                out.append(11)
            elif tw > th and c < 2:
                out.append(16)
            else:
                s = r + c
                out.append(1 if s < 2 else 6 if s < 4 else 21)
    return tuple(out)


def sm_weights(log2n: int) -> tuple:
    start = (1 << log2n) - 4
    return SM_WEIGHTS[start:start + (1 << log2n)]


def qctx(base_q_idx: int) -> int:
    return 0 if base_q_idx <= 20 else 1 if base_q_idx <= 60 else 2 if base_q_idx <= 120 else 3
